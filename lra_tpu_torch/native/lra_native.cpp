// Native runtime components: sequence data loader + minimizer extraction.
//
// The reference's runtime I/O layer is C++ over htslib/kseq
// (reference: Input.h:23-421, MinCount.h:8-179); this library provides the
// TPU framework's native equivalents, exposed through a plain C ABI and
// bound with ctypes (no pybind11 in the image).
//
//   - lrn_load_seqs: stream FASTA/FASTQ (plain or gzip) into one
//     concatenated 2-bit code buffer + per-record offsets/names.
//     Two-call protocol: pass null buffers to obtain sizes.
//   - lrn_minimizers: canonical windowed-minimum minimizer extraction,
//     identical semantics to index/minimizers.py (leftmost tie-break,
//     N-window masking, strand bit as separate array).
//
// Build: make -C lra_tpu_torch/native  (g++ -O3 -shared -fPIC, links zlib).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

const uint8_t N_CODE = 4;

inline uint8_t code_of(int c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return N_CODE;
  }
}

struct Reader {
  gzFile f;
  explicit Reader(const char* path) { f = gzopen(path, "rb"); }
  ~Reader() { if (f) gzclose(f); }
  bool ok() const { return f != nullptr; }
  int getc_() { return gzgetc(f); }
  bool getline(std::string& out) {
    out.clear();
    int c;
    while ((c = gzgetc(f)) != -1) {
      if (c == '\n') return true;
      if (c != '\r') out.push_back(static_cast<char>(c));
    }
    return !out.empty();
  }
};

struct Rec {
  std::string name;
  std::string seq;
  std::string qual;
};

// Streaming record parser for FASTA/FASTQ.
struct SeqStream {
  Reader r;
  int format;  // 0 unknown, 1 fasta, 2 fastq
  std::string pending;  // lookahead line (fasta headers)
  bool have_pending = false;

  explicit SeqStream(const char* path) : r(path), format(0) {}

  bool next(Rec& rec) {
    std::string line;
    if (!have_pending) {
      if (!r.getline(line)) return false;
    } else {
      line = pending;
      have_pending = false;
    }
    while (line.empty()) {
      if (!r.getline(line)) return false;
    }
    if (line[0] == '>') {
      format = 1;
      size_t sp = line.find_first_of(" \t");
      rec.name = line.substr(1, sp == std::string::npos ? std::string::npos
                                                        : sp - 1);
      rec.seq.clear();
      rec.qual.clear();
      while (r.getline(line)) {
        if (!line.empty() && line[0] == '>') {
          pending = line;
          have_pending = true;
          break;
        }
        rec.seq += line;
      }
      return true;
    }
    if (line[0] == '@') {
      format = 2;
      size_t sp = line.find_first_of(" \t");
      rec.name = line.substr(1, sp == std::string::npos ? std::string::npos
                                                        : sp - 1);
      if (!r.getline(rec.seq)) return false;
      std::string plus;
      if (!r.getline(plus)) return false;
      if (!r.getline(rec.qual)) return false;
      return true;
    }
    return false;
  }
};

// Emit refine-lane traceback blocks the reference's way
// (IndelRefine.h:715-745): one block per (diagonal run, single-kind gap
// run) pair, INCLUDING zero-length blocks between an insertion run and
// a deletion run — they are the op-order markers that keep e.g.
// `xD yI` from flipping to `yI xD` when the CIGAR is rebuilt from block
// gaps.  ops is in reverse order (codes 1=LEFT 2=DOWN 3=DIAG) and
// excludes the forced origin cell, so the leading diagonal run is the
// reference's first block minus that base.  Returns count or -1.
int64_t emit_refine_blocks(const std::vector<int8_t>& ops,
                           int64_t* blocks_out, int64_t max_blocks) {
  const int8_t A_LEFT = 1, A_DIAG = 3;
  int64_t nb = 0, qPos = 0, tPos = 0;
  int64_t oi = (int64_t)ops.size() - 1;
  bool first = true;
  while (oi >= 0 || first) {
    int64_t run = 0;
    while (oi >= 0 && ops[oi] == A_DIAG) { run++; oi--; }
    int64_t qg = 0, tg = 0;
    if (oi >= 0) {
      if (ops[oi] == A_LEFT) {
        while (oi >= 0 && ops[oi] == A_LEFT) { qg++; oi--; }
      } else {
        while (oi >= 0 && ops[oi] != A_LEFT && ops[oi] != A_DIAG) {
          tg++; oi--;
        }
      }
    }
    if (nb >= max_blocks) return -1;
    blocks_out[nb * 3 + 0] = qPos;
    blocks_out[nb * 3 + 1] = tPos;
    blocks_out[nb * 3 + 2] = run;
    nb++;
    qPos += run + qg;
    tPos += run + tg;
    first = false;
  }
  return nb;
}

}  // namespace

extern "C" {

// Must match lra_tpu_torch/native/__init__.py:_ABI_VERSION; bump both whenever
// an existing exported signature changes so a stale prebuilt .so can
// never be called through mismatched argtypes.
int lrn_abi_version() { return 5; }

// Two-call protocol. First call with codes=nullptr fills *total_len,
// *n_seqs, *names_len. Second call fills buffers.
// offsets: int64[n_seqs+1] cumulative code offsets.
// names: '\n'-joined record names (names_len bytes incl. separators).
// quals: optional (may be null) — Phred+33 bytes aligned with codes.
// Returns 0 on success, negative errno-style codes otherwise.
int lrn_load_seqs(const char* path,
                  uint8_t* codes, int64_t codes_cap,
                  int64_t* offsets, int64_t offsets_cap,
                  char* names, int64_t names_cap,
                  uint8_t* quals,
                  int64_t* total_len, int64_t* n_seqs,
                  int64_t* names_len) {
  SeqStream s(path);
  if (!s.r.ok()) return -1;
  Rec rec;
  int64_t tl = 0, ns = 0, nl = 0;
  bool fill = codes != nullptr;
  if (fill && offsets_cap > 0) offsets[0] = 0;
  while (s.next(rec)) {
    if (fill) {
      if (tl + static_cast<int64_t>(rec.seq.size()) > codes_cap) return -2;
      if (ns + 2 > offsets_cap) return -3;
      if (nl + static_cast<int64_t>(rec.name.size()) + 1 > names_cap)
        return -4;
      for (size_t i = 0; i < rec.seq.size(); i++) {
        codes[tl + i] = code_of(rec.seq[i]);
      }
      if (quals != nullptr) {
        if (rec.qual.size() == rec.seq.size()) {
          memcpy(quals + tl, rec.qual.data(), rec.qual.size());
        } else {
          memset(quals + tl, 0xFF, rec.seq.size());
        }
      }
      memcpy(names + nl, rec.name.data(), rec.name.size());
      names[nl + rec.name.size()] = '\n';
      offsets[ns + 1] = tl + static_cast<int64_t>(rec.seq.size());
    }
    tl += static_cast<int64_t>(rec.seq.size());
    nl += static_cast<int64_t>(rec.name.size()) + 1;
    ns += 1;
  }
  *total_len = tl;
  *n_seqs = ns;
  *names_len = nl;
  return 0;
}

// Canonical minimizer extraction; identical semantics to
// index/minimizers.py (leftmost tie-break, windows with N dropped,
// distinct occurrences by position).  Returns count, or -1 if cap too
// small.  out_* arrays must hold at least `cap` entries.
int64_t lrn_minimizers(const uint8_t* codes, int64_t len, int k, int w,
                       int canonical,
                       uint64_t* out_tuple, uint32_t* out_pos,
                       uint8_t* out_strand, int64_t cap) {
  if (len < k + w - 1) return 0;
  const int64_t nk = len - k + 1;
  const uint64_t mask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  std::vector<uint64_t> canon(nk);
  std::vector<uint8_t> strand(nk);
  std::vector<uint8_t> valid(nk);

  uint64_t fwd = 0, rc = 0;
  int bad_run = 0;  // bases since last N within the current k-window
  const int shift_rc = 2 * (k - 1);
  // prime first k-1 bases
  int64_t i = 0;
  for (; i < len; i++) {
    uint8_t c = codes[i];
    uint8_t b = (c >= 4) ? 0 : c;
    fwd = ((fwd << 2) | b) & mask;
    rc = (rc >> 2) | (static_cast<uint64_t>(3 - b) << shift_rc);
    if (c >= 4) bad_run = 0; else bad_run++;
    if (i >= k - 1) {
      int64_t p = i - k + 1;
      valid[p] = bad_run >= k;
      if (canonical) {
        if (rc < fwd) { canon[p] = rc; strand[p] = 1; }
        else { canon[p] = fwd; strand[p] = 0; }
      } else {
        canon[p] = fwd;
        strand[p] = 0;
      }
    }
  }

  // sliding window minimum with leftmost tie-break (monotonic deque)
  std::vector<int64_t> deque_idx(nk);
  int64_t qh = 0, qt = 0;  // [qh, qt)
  int64_t count = 0;
  int64_t last_pos = -1;
  // windows with any invalid k-mer are skipped; track last invalid
  int64_t last_bad = -1;
  for (int64_t p = 0; p < nk; p++) {
    if (!valid[p]) last_bad = p;
    // evict out-of-window from front
    while (qh < qt && deque_idx[qh] <= p - w) qh++;
    // evict strictly larger from back (keep leftmost among equals)
    while (qh < qt && canon[deque_idx[qt - 1]] > canon[p]) qt--;
    deque_idx[qt++] = p;
    int64_t win_start = p - w + 1;
    if (win_start < 0) continue;
    if (last_bad >= win_start) continue;  // window touches an N
    int64_t mp = deque_idx[qh];
    if (mp != last_pos) {
      if (count >= cap) return -1;
      out_tuple[count] = canon[mp];
      out_pos[count] = static_cast<uint32_t>(mp);
      out_strand[count] = strand[mp];
      count++;
      last_pos = mp;
    }
  }
  return count;
}

// Exact-reference minimizer extraction (reference: MinCount.h:8-179
// StoreMinimizers / MinCount.h:182-338 StoreMinimizers_noncanonical).
// Unlike lrn_minimizers' leftmost rule, the reference's streaming machine
// has three observable quirks this routine reproduces bit-for-bit:
//   1. emission is change-driven: one occurrence per *change* of the
//      active minimizer (strict-less on slide keeps the older occurrence;
//      in a run of equal tuples only ~1 per w is emitted, not every
//      position);
//   2. on expiry the active is recomputed by scanning the circular buffer
//      from slot 0 with strict less (MinCount.h:148-154), so ties go to
//      the smallest position mod w;
//   3. the first window's comparison is UNMASKED (MinCount.h:91), so
//      reverse-strand canonical k-mers carry the strand MSB and lose to
//      any forward k-mer.
// Validity gating over N runs follows the reference's tracked-end pointer
// (MinCount.h:23-41,109-132), including its two edge quirks: a window
// placement flush with the sequence end is never found by the re-search
// (the scan stops at len - span - 1), and a failed re-search stops
// extraction entirely.  N bases pack as A (SeqUtils.h:7 seqMap) but are
// tracked separately for validity (seqMapN).
// Returns count, or -1 if cap too small.
int64_t lrn_minimizers_ref(const uint8_t* codes, int64_t len, int k, int w,
                           int canonical,
                           uint64_t* out_tuple, uint32_t* out_pos,
                           uint8_t* out_strand, int64_t cap) {
  const int64_t span = static_cast<int64_t>(w) + k - 1;
  if (len < k || len < span) return 0;
  const int64_t nk = len - k + 1;
  const uint64_t mask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  // one rolling pass: masked canonical value + strand per k-mer start
  std::vector<uint64_t> mv(nk);
  std::vector<uint8_t> str(nk);
  {
    uint64_t fwd = 0, rc = 0;
    const int shift_rc = 2 * (k - 1);
    for (int64_t i = 0; i < len; i++) {
      uint8_t c = codes[i];
      uint8_t b = (c >= 4) ? 0 : c;
      fwd = ((fwd << 2) | b) & mask;
      rc = (rc >> 2) | (static_cast<uint64_t>(3 - b) << shift_rc);
      if (i >= k - 1) {
        int64_t p = i - k + 1;
        if (canonical && rc < fwd) { mv[p] = rc; str[p] = 1; }
        else { mv[p] = fwd; str[p] = 0; }
      }
    }
  }
  // validity tracker: vend is the reference's nextValidWindowEnd; the
  // window of k-mers ending at p may emit iff vend == p + k.
  int64_t vend = -1;
  auto research = [&](int64_t from) -> bool {
    int64_t clean = 0;
    for (int64_t i = from; i < len; i++) {
      if (codes[i] < 4) clean++; else clean = 0;
      if (clean >= span && (i - span + 1) < len - span) {
        vend = i + 1;
        return true;
      }
    }
    return false;
  };
  if (!research(0)) return 0;

  // first window [0, w): leftmost strict-min by UNMASKED value
  const uint64_t msb = 1ull << 63;
  int64_t active = 0;
  std::vector<int64_t> ring(w);
  ring[0] = 0;
  uint64_t abest = mv[0] | (str[0] ? msb : 0);
  for (int64_t p = 1; p < w; p++) {
    ring[p % w] = p;
    uint64_t v = mv[p] | (str[p] ? msb : 0);
    if (v < abest) { abest = v; active = p; }
  }
  int64_t count = 0;
  auto emit = [&](int64_t p) -> bool {
    if (count >= cap) return false;
    out_tuple[count] = mv[p];
    out_pos[count] = static_cast<uint32_t>(p);
    out_strand[count] = str[p];
    count++;
    return true;
  };
  if (vend == span && !emit(active)) return -1;

  for (int64_t p = w; p < nk; p++) {
    const int64_t b = p + k - 1;  // newest base of this window
    if (vend == b) {
      if (codes[b] < 4) {
        vend++;
      } else if (!research(p + k)) {
        return count;  // the reference returns mid-scan
      }
    }
    ring[p % w] = p;
    if (active <= p - w) {
      // expired: rescan the ring from slot 0 with strict less
      int64_t best = ring[0];
      for (int j = 1; j < w; j++)
        if (mv[ring[j]] < mv[best]) best = ring[j];
      active = best;
      if (vend == p + k && !emit(active)) return -1;
    } else if (mv[p] < mv[active]) {
      active = p;
      if (vend == p + k && !emit(active)) return -1;
    }
  }
  return count;
}

// Stable counting argsort for small-range int32 keys (frequency ranks in
// the per-window thinning, MMIndex.h:358-376).  Falls back to -1 if the
// range exceeds `max_range` so the caller can use numpy.
int lrn_counting_argsort_i32(const int32_t* keys, int64_t n,
                             int32_t max_range, int64_t* out_idx) {
  if (n <= 0) return 0;
  int32_t lo = keys[0], hi = keys[0];
  for (int64_t i = 1; i < n; i++) {
    if (keys[i] < lo) lo = keys[i];
    if (keys[i] > hi) hi = keys[i];
  }
  const int64_t range = static_cast<int64_t>(hi) - lo + 1;
  if (range > max_range) return -1;
  std::vector<int64_t> cnt(range + 1, 0);
  for (int64_t i = 0; i < n; i++) cnt[keys[i] - lo]++;
  int64_t pos = 0;
  std::vector<int64_t> off(range, 0);
  for (int64_t b = 0; b < range; b++) { off[b] = pos; pos += cnt[b]; }
  for (int64_t i = 0; i < n; i++) out_idx[off[keys[i] - lo]++] = i;
  return 0;
}

// Local index build: per `window`-sized slice of `codes`, non-canonical
// minimizers sorted by (tuple, pos) with per-window frequency cap
// count < max_freq (index/local_index.py:build_local_index; reference:
// LocalIndex::IndexSeq, MMIndex.h:200-254).  out_bounds: int64[nwin+1].
// Returns total rows or -1 if cap exceeded.
int64_t lrn_local_index_build(const uint8_t* codes, int64_t len,
                              int k, int w, int window, int max_freq,
                              int exact,
                              uint64_t* out_tuples, uint32_t* out_pos,
                              int64_t* out_bounds, int64_t cap) {
  const int64_t nwin = (len + window - 1) / window;
  int64_t total = 0;
  out_bounds[0] = 0;
  std::vector<uint64_t> tup(window + 1);
  std::vector<uint32_t> pos(window + 1);
  std::vector<uint8_t> str(window + 1);
  std::vector<int32_t> idx;
  for (int64_t wi = 0; wi < nwin; wi++) {
    const int64_t s = wi * window;
    const int64_t e = std::min(len, s + window);
    const int64_t n =
        exact ? lrn_minimizers_ref(codes + s, e - s, k, w, 0, tup.data(),
                                   pos.data(), str.data(), window + 1)
              : lrn_minimizers(codes + s, e - s, k, w, 0, tup.data(),
                               pos.data(), str.data(), window + 1);
    if (n < 0) return -1;
    idx.resize(n);
    for (int64_t i = 0; i < n; i++) idx[i] = static_cast<int32_t>(i);
    std::stable_sort(idx.begin(), idx.end(),
                     [&](int32_t a, int32_t b) { return tup[a] < tup[b]; });
    int64_t i = 0;
    while (i < n) {
      int64_t j = i;
      while (j < n && tup[idx[j]] == tup[idx[i]]) j++;
      if (j - i < max_freq) {
        for (int64_t r = i; r < j; r++) {
          if (total >= cap) return -1;
          out_tuples[total] = tup[idx[r]];
          out_pos[total] = pos[idx[r]];
          total++;
        }
      }
      i = j;
    }
    out_bounds[wi + 1] = total;
  }
  return total;
}

// Local-index reseeding walk: for each genome local-index window in
// [ls, le], project the cluster's anchors to a read range, intersect the
// window's minimizers with the read's local-index windows covering that
// range, and emit band/box-filtered (q, t) seed pairs — the per-cluster
// inner loop of REFINEclusters (pipeline/refine.py:refine_clusters;
// reference: ClusterRefine.h:51-240).  Returns count or -1 if cap hit.
int64_t lrn_local_reseed(
    const uint64_t* g_tuples, const uint32_t* g_pos,
    const int64_t* g_seqoff, const int64_t* g_bounds,
    int64_t ls, int64_t le, int64_t chrom_off,
    const uint64_t* r_tuples, const uint32_t* r_pos,
    const int64_t* r_seqoff, const int64_t* r_bounds, int64_t r_nwin,
    int64_t read_len, int64_t max_freq, int64_t margin,
    const int64_t* t_sorted, const int64_t* q_by_t,
    const int64_t* qend_by_t, int64_t n_anchor, int lowacc_walk,
    int64_t min_dn, int64_t max_dn, int64_t qlo, int64_t qhi,
    int64_t tlo, int64_t thi,
    int64_t* out_q, int64_t* out_t, int64_t cap) {
  int64_t cnt = 0;
  auto lookup = [&](int64_t p) -> int64_t {
    // searchsorted(r_seqoff, p, 'left'); exact hit keeps i, else i-1
    const int64_t* lo = std::lower_bound(r_seqoff, r_seqoff + r_nwin + 1, p);
    int64_t i = lo - r_seqoff;
    if (i > r_nwin || r_seqoff[i] != p) i = std::max<int64_t>(0, i - 1);
    return i;
  };
  for (int64_t lsi = ls; lsi <= le; lsi++) {
    const int64_t g_lo = g_seqoff[lsi] - chrom_off;
    const int64_t g_hi = g_seqoff[lsi + 1] - 1 - chrom_off;
    if (g_lo >= g_hi || g_lo < 0) continue;
    int64_t r_lo, r_hi;
    if (lowacc_walk) {
      // Refine_splitchain walk (reference: ChainRefine.h:463-485):
      // anchors with tStart strictly inside (g_lo, g_hi); per-window
      // read range = [min qStart, max qEnd] over that range — the qEnd
      // side is what reaches the read-tail index window when the
      // outermost anchor starts in the previous one
      int64_t m_s = std::upper_bound(t_sorted, t_sorted + n_anchor, g_lo)
          - t_sorted;
      int64_t m_e = std::lower_bound(t_sorted + m_s, t_sorted + n_anchor,
                                     g_hi) - t_sorted;
      if (m_s >= n_anchor || m_e == m_s) continue;
      r_lo = q_by_t[m_s];
      r_hi = qend_by_t[m_s];
      for (int64_t mi = m_s + 1; mi < m_e; mi++) {
        r_lo = std::min(r_lo, q_by_t[mi]);
        r_hi = std::max(r_hi, qend_by_t[mi]);
      }
    } else {
      // REFINEclusters walk (reference: ClusterRefine.h:142-158):
      // inclusive bounds, endpoint anchors' q starts only
      int64_t m_s = std::lower_bound(t_sorted, t_sorted + n_anchor, g_lo)
          - t_sorted;
      int64_t m_e = std::upper_bound(t_sorted, t_sorted + n_anchor, g_hi)
          - t_sorted;
      if (m_s >= n_anchor) continue;
      m_e = std::min(m_e, n_anchor - 1);
      r_lo = q_by_t[m_s];
      r_hi = q_by_t[m_e];
      if (r_lo > r_hi) std::swap(r_lo, r_hi);
    }
    if (lsi == ls) r_lo = std::max<int64_t>(0, r_lo - margin);
    if (lsi == le) r_hi = std::min(read_len, r_hi + margin);
    if (r_lo > r_hi) continue;
    const int64_t qi_s = lookup(r_lo);
    const int64_t qi_e = lookup(std::min(r_hi, read_len - 1));
    const int64_t gb_lo = g_bounds[lsi], gb_hi = g_bounds[lsi + 1];
    if (gb_hi <= gb_lo) continue;
    for (int64_t qi = qi_s; qi <= qi_e; qi++) {
      const int64_t a = r_bounds[qi], b = r_bounds[qi + 1];
      if (b <= a) continue;
      const int64_t roff = r_seqoff[qi];
      int64_t i = a;
      while (i < b) {
        int64_t j = i;
        while (j < b && r_tuples[j] == r_tuples[i]) j++;
        if (j - i <= max_freq) {
          const uint64_t key = r_tuples[i];
          int64_t lo = std::lower_bound(g_tuples + gb_lo, g_tuples + gb_hi,
                                        key) - g_tuples;
          int64_t hi = std::upper_bound(g_tuples + gb_lo, g_tuples + gb_hi,
                                        key) - g_tuples;
          for (int64_t r = i; r < j; r++) {
            const int64_t qp = static_cast<int64_t>(r_pos[r]) + roff;
            for (int64_t g = lo; g < hi; g++) {
              const int64_t tp = static_cast<int64_t>(g_pos[g]) + g_lo;
              const int64_t diag = tp - qp;
              if (diag >= min_dn && diag <= max_dn && qp >= qlo &&
                  qp < qhi && tp >= tlo && tp < thi) {
                if (cnt >= cap) return -1;
                out_q[cnt] = qp;
                out_t[cnt] = tp;
                cnt++;
              }
            }
          }
        }
        i = j;
      }
    }
  }
  return cnt;
}

// Linear anchor extension: merge co-diagonal K-length anchors into
// maximal exact matches by literal base comparison (the two-pointer walk
// of align/extend.py:linear_extend_cluster, semantics of the reference's
// LinearExtend.h:137-360 incl. Checkbp and CheckOverlap).  Anchors arrive
// diagonal-sorted; outputs are capped at 2n+1 entries.
// Returns the number of emitted anchors.
int64_t lrn_linear_extend(const uint8_t* read, int64_t /*qlen*/,
                          const uint8_t* chrom, int64_t tlen,
                          const int64_t* q, const int64_t* t, int64_t n,
                          int32_t strand, int32_t K,
                          const int64_t* pt_coord, const uint8_t* pt_is_t,
                          int64_t npts,
                          int64_t* out_q, int64_t* out_t,
                          int64_t* out_len, uint8_t* out_ovp) {
  if (n == 0) return 0;
  int64_t cnt = 0;
  auto has_overlap = [&](int64_t i) -> bool {
    for (int64_t p = 0; p < npts; p++) {
      if (!pt_is_t[p] && q[i] <= pt_coord[p] && pt_coord[p] < q[i] + K)
        return true;
      if (pt_is_t[p] && t[i] <= pt_coord[p] && pt_coord[p] < t[i] + K)
        return true;
    }
    return false;
  };
  auto first_mm_fwd = [&](int64_t q0, int64_t t0, int64_t q_hi,
                          int64_t t_hi) -> int64_t {
    int64_t m = std::min(q_hi - q0, t_hi - t0);
    if (m <= 0) return 0;
    int64_t s = 0;
    // 8 bytes per step: XOR of unaligned loads is 0 iff all equal
    for (; s + 8 <= m; s += 8) {
      uint64_t a, b;
      std::memcpy(&a, read + q0 + s, 8);
      std::memcpy(&b, chrom + t0 + s, 8);
      uint64_t x = a ^ b;
      if (x) return s + (int64_t)(__builtin_ctzll(x) >> 3);
    }
    for (; s < m; s++)
      if (read[q0 + s] != chrom[t0 + s]) return s;
    return m;
  };
  auto first_mm_rev = [&](int64_t q0, int64_t t0, int64_t q_hi) -> int64_t {
    int64_t m = std::min(q_hi - q0, t0 + 1);
    if (m <= 0) return 0;
    int64_t s = 0;
    // RAW (uncomplemented) byte equality, chrom walked descending =
    // byteswapped load: the reference's Checkbp rev loop compares
    // genome.seqs[curT] == read.seq[curQ] with NO complement
    // (LinearExtend.h:77-82) — rev-strand extension proceeds only on
    // coincidental raw equality, and complementing here was a measured
    // bit-identity residual (it extended runs one base further)
    for (; s + 8 <= m; s += 8) {
      uint64_t a, c;
      std::memcpy(&a, read + q0 + s, 8);
      std::memcpy(&c, chrom + t0 - s - 7, 8);
      c = __builtin_bswap64(c);
      uint64_t x = a ^ c;
      if (x) return s + (int64_t)(__builtin_ctzll(x) >> 3);
    }
    for (; s < m; s++) {
      if (read[q0 + s] != chrom[t0 - s]) return s;
    }
    return m;
  };
  // ext ends < 0 mean "default"
  auto emit_run = [&](int64_t m, int64_t last, int64_t ext_q_end,
                      int64_t ext_t_end) {
    int64_t qe = ext_q_end >= 0 ? ext_q_end : q[last] + K;
    if (strand == 0) {
      out_q[cnt] = q[m];
      out_t[cnt] = t[m];
      out_len[cnt] = qe - q[m];
    } else {
      int64_t te = ext_t_end >= 0 ? ext_t_end : t[last];
      out_q[cnt] = q[m];
      out_t[cnt] = te;
      out_len[cnt] = qe - q[m];
    }
    out_ovp[cnt] = 0;
    cnt++;
  };
  int64_t m = 0, i = 1;
  bool chm = true;
  while (i < n) {
    if (chm && has_overlap(m)) {
      out_q[cnt] = q[m]; out_t[cnt] = t[m];
      out_len[cnt] = K; out_ovp[cnt] = 1; cnt++;
      m = i; i++; chm = true;
      continue;
    }
    if (has_overlap(i)) {
      emit_run(m, i - 1, -1, -1);
      out_q[cnt] = q[i]; out_t[cnt] = t[i];
      out_len[cnt] = K; out_ovp[cnt] = 1; cnt++;
      m = i + 1; i = m + 1; chm = true;
      continue;
    }
    bool same_diag = (strand == 0)
        ? (q[i - 1] - t[i - 1]) == (q[i] - t[i])
        : (q[i - 1] + t[i - 1]) == (q[i] + t[i]);
    if (same_diag) {
      if (q[i] < q[i - 1] + K) {
        i++;
      } else if (strand == 0) {
        int64_t ext = first_mm_fwd(q[i - 1] + K,
                                   std::min(tlen, t[i - 1] + K),
                                   q[i], std::min(tlen, t[i]));
        int64_t qe = q[i - 1] + K + ext;
        if (qe == q[i]) {
          i++;
        } else {
          emit_run(m, i - 1, qe, -1);
          m = i; i++;
        }
      } else {
        int64_t ext = first_mm_rev(q[i - 1] + K,
                                   std::min(tlen - 1, t[i - 1] - 1), q[i]);
        int64_t qe = q[i - 1] + K + ext;
        int64_t te_final = t[i - 1] - 1 - ext;
        if (qe == q[i] && te_final == t[i] + K - 1) {
          i++;
        } else {
          emit_run(m, i - 1, qe, te_final + 1);
          m = i; i++;
        }
      }
    } else {
      emit_run(m, i - 1, -1, -1);
      m = i; i++;
    }
    chm = false;
  }
  if (m < n) emit_run(m, n - 1, -1, -1);
  return cnt;
}

// Batched global-index anchor intersection (the CompareLists analog,
// reference: CompareLists.h:9): for each read, its minimizers are
// stable-sorted by tuple, per-read multiplicity runs over the read
// minimizers are capped at max_freq, surviving tuples binary-search the
// sorted index and expand every hit.  Output order matches the numpy
// implementation in anchors.find_matches_batch exactly (rid-major,
// tuple-minor with stable ties, hits in index row order) so downstream
// stable sorts see identical tie ordering.  Returns the total match
// count, or -(needed) when `cap` is insufficient.
// First-level lookup table over tuple prefixes: lut[p] = first index
// row whose (tuple >> shift) >= p, lut[nbuckets] = ni.  Narrows each
// binary search from log2(ni) cache-missing probes to a handful inside
// one bucket — the dominant anchor-stage cost on 100Mb+ genomes.
extern "C" void lrn_match_lut_build(const uint64_t* it, int64_t ni,
                                    int64_t shift, int64_t* lut,
                                    int64_t nbuckets) {
  int64_t i = 0;
  for (int64_t p = 0; p <= nbuckets; p++) {
    while (i < ni && (int64_t)(it[i] >> shift) < p) i++;
    lut[p] = i;
  }
}

int64_t lrn_match_batch(
    const uint64_t* qt, const uint32_t* qp, const uint8_t* qs, int64_t nq,
    const int64_t* read_off, int64_t n_reads,
    const uint64_t* it, const uint32_t* ip, const uint8_t* istr,
    const int32_t* ifr, int64_t ni, int64_t max_freq,
    const int64_t* lut, int64_t lut_shift, int64_t lut_nbuckets,
    int64_t* out_qpos, int64_t* out_tpos, int64_t* out_freq,
    uint8_t* out_rev, int64_t* out_read_start, int64_t cap) {
  std::vector<int64_t> order;
  int64_t total = 0;
  bool fits = true;
  for (int64_t r = 0; r < n_reads; r++) {
    out_read_start[r] = total;
    int64_t lo = read_off[r], hi = read_off[r + 1];
    order.resize(hi - lo);
    for (int64_t i = lo; i < hi; i++) order[i - lo] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) { return qt[a] < qt[b]; });
    int64_t m = 0, n = (int64_t)order.size();
    while (m < n) {
      int64_t e = m + 1;
      while (e < n && qt[order[e]] == qt[order[m]]) e++;
      if (e - m <= max_freq) {
        const uint64_t key = qt[order[m]];
        const uint64_t* base = it;
        const uint64_t* end = it + ni;
        if (lut) {
          int64_t p = (int64_t)(key >> lut_shift);
          if (p > lut_nbuckets - 1) p = lut_nbuckets - 1;
          base = it + lut[p];
          end = it + lut[p + 1];
        }
        const uint64_t* l = std::lower_bound(base, end, key);
        const uint64_t* u = std::upper_bound(l, end, key);
        if (u > l) {
          int64_t ilo = l - it, icnt = u - l;
          for (int64_t o = m; o < e; o++) {
            int64_t occ = order[o];
            for (int64_t k = 0; k < icnt; k++) {
              if (total < cap) {
                int64_t row = ilo + k;
                out_qpos[total] = (int64_t)qp[occ];
                out_tpos[total] = (int64_t)ip[row];
                out_freq[total] = (int64_t)ifr[row];
                out_rev[total] = qs[occ] != istr[row];
              } else {
                fits = false;
              }
              total++;
            }
          }
        }
      }
      m = e;
    }
  }
  out_read_start[n_reads] = total;
  return fits ? total : -total;
}

// Banded global alignment + traceback for ONE problem on the host —
// the native fast path behind align/affine.fast_one_gap_align (scalar
// mirror of ops/affine_kernel.banded_global_np: same recurrence, same
// boundary init, same ins > del > match tie order, so traceback blocks
// are identical).  numpy pays ~35us of per-row dispatch on the ~10 row
// ops; a 1000x61 band is ~60k cells, microseconds in C.
//
// Layout: rows j = 0..tlen, band offsets d = 0..2K (diagonal off - K),
// cell (i, j) with i = j + d - K.  Returns the block count (triples
// q_off, t_off, len ascending into blocks_out), or -1 on overflow;
// score_out receives the alignment score.
int lrn_banded_align(const int8_t* q, int32_t qlen, const int8_t* t,
                     int32_t tlen, int32_t K, int32_t kband, int32_t m,
                     int32_t mm, int32_t indel, int32_t* blocks_out,
                     int32_t max_blocks, int32_t* score_out) {
  const int32_t NEGI = -1000000000;
  const int8_t A_DONE = 0, A_LEFT = 1, A_DOWN = 2, A_DIAG = 3;
  const int band = 2 * K + 1;
  std::vector<int8_t> arrows((size_t)(tlen + 1) * band, -1);
  std::vector<int32_t> prev(band), row(band), sdel(band);

  // row 0: P[i, 0] = indel*i for 0 <= offs <= kband
  for (int d = 0; d < band; d++) {
    int offs = d - K;
    bool inb = offs >= -kband && offs <= kband;
    prev[d] = (inb && offs >= 0) ? indel * offs : NEGI;
    arrows[d] = (inb && offs > 0) ? A_LEFT : (inb && offs == 0 ? A_DONE : -1);
  }
  for (int j = 1; j <= tlen; j++) {
    int8_t tc = t[j - 1];
    for (int d = 0; d < band; d++) {
      int i = j + d - K;
      int8_t qc = (i - 1 >= 0 && i - 1 < qlen) ? q[i - 1] : (int8_t)5;
      int32_t sub = (qc == tc) ? m : mm;
      int32_t sMat = prev[d] + sub;
      int32_t sd = (d + 1 < band) ? prev[d + 1] + indel : NEGI;
      int32_t base = sMat > sd ? sMat : sd;
      if (i == 0) base = indel * j;
      bool inb = (d - K) >= -kband && (d - K) <= kband;
      bool valid = i >= 0 && i <= qlen && inb;
      if (!valid) base = NEGI;
      int32_t v = base;
      if (d > 0 && row[d - 1] + indel > v) v = row[d - 1] + indel;
      row[d] = v;
      sdel[d] = sd;
    }
    int8_t* arr = &arrows[(size_t)j * band];
    for (int d = 0; d < band; d++) {
      int i = j + d - K;
      bool inb = (d - K) >= -kband && (d - K) <= kband;
      bool valid = i >= 0 && i <= qlen && inb;
      if (!valid) { row[d] = NEGI; }
    }
    for (int d = 0; d < band; d++) {
      int i = j + d - K;
      bool inb = (d - K) >= -kband && (d - K) <= kband;
      bool valid = i >= 0 && i <= qlen && inb;
      int32_t row_left = d > 0 ? row[d - 1] : NEGI;
      int8_t a;
      if (row[d] == row_left + indel) a = A_LEFT;
      else if (row[d] == sdel[d]) a = A_DOWN;
      else a = A_DIAG;
      if (i == 0) a = A_DOWN;
      if (!valid) a = -1;
      arr[d] = a;
    }
    std::swap(prev, row);
  }
  if (score_out) {
    int df = qlen - tlen + K;
    *score_out = (df >= 0 && df < band) ? prev[df] : NEGI;
  }

  // traceback (mirror of affine_kernel.traceback_banded)
  int i = qlen, j = tlen;
  int nb = 0;
  int run = 0, run_i = 0, run_j = 0;
  // collect blocks end-first, reverse at the end
  std::vector<int32_t> rev;
  while (i >= 0 && j >= 0) {
    int d = i - j + K;
    if (d < 0 || d >= band) break;
    int8_t a = arrows[(size_t)j * band + d];
    if (a == A_DONE || a == -1) break;
    if (a == A_DIAG) {
      run++; run_i = i - 1; run_j = j - 1;
      i--; j--;
    } else {
      if (run) { rev.push_back(run_i); rev.push_back(run_j);
                 rev.push_back(run); run = 0; }
      if (a == A_LEFT) i--; else j--;
    }
  }
  if (run) { rev.push_back(run_i); rev.push_back(run_j); rev.push_back(run); }
  int nruns = (int)(rev.size() / 3);
  if (nruns > max_blocks) return -1;
  for (int r = nruns - 1; r >= 0; r--) {
    blocks_out[nb * 3 + 0] = rev[r * 3 + 0];
    blocks_out[nb * 3 + 1] = rev[r * 3 + 1];
    blocks_out[nb * 3 + 2] = rev[r * 3 + 2];
    nb++;
  }
  return nb;
}

// CIGAR text from op-run arrays: codes index into op_chars, lens are
// run lengths.  Python's per-run f-string join costs ~0.3ms per read
// (align/cigar.score_op_arrays); this is the whole loop in C.  Returns
// bytes written, or -1 if cap is too small.
int64_t lrn_cigar_string(const uint8_t* codes, const int64_t* lens,
                         int64_t n, const char* op_chars, char* out,
                         int64_t cap) {
  char* p = out;
  char* end = out + cap;
  for (int64_t i = 0; i < n; i++) {
    if (p + 24 > end) return -1;
    long long v = (long long)lens[i];
    // itoa (lens are positive)
    char tmp[20];
    int k = 0;
    do { tmp[k++] = (char)('0' + v % 10); v /= 10; } while (v);
    while (k) *p++ = tmp[--k];
    *p++ = op_chars[codes[i]];
  }
  return (int64_t)(p - out);
}

// Decode a bucket of 2-bit-packed device-traceback op planes straight
// into match-block triples (the host inverse of
// affine_kernel.banded_global_traced_packed, replacing the numpy
// unpack_ops + blocks_from_ops_batch pair on the hot path).  Plane rows
// are END-of-alignment-first (LEFT=1 DOWN=2 DIAG=3, terminator 0); the
// output blocks are in ascending alignment order.
//   packed:  [B, L4] uint8, 4 ops/byte (op l = byte l/4 bits (l%4)*2)
//   out:     cap*3 int32 (q_off, t_off, len) triples, rows concatenated
//   counts:  B int32, blocks per row
// Returns total triples written, or -1 if cap exceeded.
extern "C" int64_t lrn_blocks_packed(const uint8_t* packed, int64_t B,
                                     int64_t L4, int32_t* out, int64_t cap,
                                     int32_t* counts) {
  int64_t total = 0;
  const int64_t L = L4 * 4;
  for (int64_t b = 0; b < B; b++) {
    const uint8_t* row = packed + b * L4;
    // find op count n: first terminator (op == 0), scanning forward.
    int64_t n = L;
    for (int64_t byte = 0; byte < L4; byte++) {
      uint8_t v = row[byte];
      if ((v & 3) == 0) { n = byte * 4; break; }
      if (((v >> 2) & 3) == 0) { n = byte * 4 + 1; break; }
      if (((v >> 4) & 3) == 0) { n = byte * 4 + 2; break; }
      if (((v >> 6) & 3) == 0) { n = byte * 4 + 3; break; }
    }
    // walk backwards (= alignment order), emitting DIAG runs
    int64_t q = 0, t = 0;
    int64_t run = 0, rq = 0, rt = 0;
    int64_t nb = 0;
    for (int64_t l = n - 1; l >= 0; l--) {
      int op = (row[l >> 2] >> ((l & 3) * 2)) & 3;
      if (op == 3) {                       // DIAG
        if (!run) { rq = q; rt = t; }
        run++; q++; t++;
      } else {
        if (run) {
          if (total + nb >= cap) return -1;
          int32_t* o = out + (total + nb) * 3;
          o[0] = (int32_t)rq; o[1] = (int32_t)rt; o[2] = (int32_t)run;
          nb++; run = 0;
        }
        if (op == 1) q++; else t++;        // LEFT consumes q, DOWN t
      }
    }
    if (run) {
      if (total + nb >= cap) return -1;
      int32_t* o = out + (total + nb) * 3;
      o[0] = (int32_t)rq; o[1] = (int32_t)rt; o[2] = (int32_t)run;
      nb++;
    }
    counts[b] = (int32_t)nb;
    total += nb;
  }
  return total;
}

// Alignment statistics + concave NV score from op-run arrays (native
// mirror of align/cigar.score_op_arrays; NV log-table scoring quirks
// reference Alignment.h:467-495).  icounts (12): nm, nmm, nins, tins,
// ndel, tdel, n_small_del, n_med_del, n_large_del, n_small_ins,
// n_med_ins, n_large_ins.
extern "C" void lrn_score_ops(const uint8_t* codes, const int64_t* lens,
                              int64_t n, const double* logtab,
                              int64_t logn, int64_t* ic, double* value) {
  for (int i = 0; i < 12; i++) ic[i] = 0;
  // the reference accumulates `value` in FLOAT (Alignment.h:54), one
  // increment per CIGAR run in run order — at megabase scale (contig
  // NV ~5e6, f32 ULP 0.5) f64 accumulation visibly diverges from the
  // reference's rounding, so f32 sequential accumulation is the parity
  // semantics, not an approximation
  float val = 0.0f;
  for (int64_t i = 0; i < n; i++) {
    int64_t l = lens[i];
    switch (codes[i]) {
      case 0: ic[0] += l; val += (float)l; break;
      case 1: ic[1] += l; val -= (float)l; break;
      case 2:                                   // I
        ic[2]++; ic[3] += l;
        if (l <= 10) ic[9]++;
        if (l <= 20) ic[9]++;                   // reference quirk kept
        if (l > 10 && l < 50) ic[10]++;
        if (l > 50) ic[11]++;
        break;
      case 3:                                   // D
        ic[4]++; ic[5] += l;
        if (l <= 10) ic[6]++;
        if (l > 10 && l < 50) ic[7]++;
        if (l > 50) ic[8]++;
        break;
    }
    if (codes[i] == 2 || codes[i] == 3) {
      if (l <= 20) val -= (float)l;
      else if (l <= 10001) {
        int64_t idx = (l - 1) / 5;
        if (idx > logn - 1) idx = logn - 1;
        // reference: value += -3.0f*LookUpTable[a] - 1 in f32
        // (Alignment.h:420,469); logtab holds f64(f32 entry) exactly
        val += -(3.0f * (float)logtab[idx]) - 1.0f;
      } else if (l <= 100001) val -= 1000.0f;
      else val -= 2000.0f;
    }
  }
  *value = (double)val;
}

// Build merged CIGAR op-run arrays from a block list in one pass
// (native mirror of align/cigar.blocks_to_op_arrays: per inter-block
// gap emit I then D then the re-aligned commonGap span, reference
// Alignment.h:292-330).  codes: 0 match, 1 X, 2 I, 3 D.
// Returns run count or -1 if cap exceeded.
extern "C" int64_t lrn_op_arrays(const int64_t* blocks, int64_t nb,
                                 const uint8_t* read, const uint8_t* chrom,
                                 int show_mismatch, uint8_t* codes_out,
                                 int64_t* lens_out, int64_t cap) {
  int64_t n = 0;
  bool overflow = false;
  auto push = [&](uint8_t c, int64_t l) {
    if (l <= 0) return;
    if (n && codes_out[n - 1] == c) { lens_out[n - 1] += l; return; }
    if (n >= cap) { overflow = true; return; }
    codes_out[n] = c;
    lens_out[n] = l;
    n++;
  };
  auto span = [&](int64_t q, int64_t t, int64_t l) {
    if (l <= 0) return;
    if (!show_mismatch) { push(0, l); return; }
    int64_t run = 0;
    uint8_t cur = 0;
    for (int64_t p = 0; p < l; p++) {
      uint8_t c = read[q + p] == chrom[t + p] ? 0 : 1;
      if (run && c == cur) { run++; continue; }
      push(cur, run);
      cur = c;
      run = 1;
    }
    push(cur, run);
  };
  for (int64_t j = 0; j < nb && !overflow; j++) {
    int64_t q = blocks[j * 3], t = blocks[j * 3 + 1], l = blocks[j * 3 + 2];
    span(q, t, l);
    if (j + 1 < nb) {
      int64_t qgap = blocks[(j + 1) * 3] - (q + l);
      int64_t tgap = blocks[(j + 1) * 3 + 1] - (t + l);
      int64_t common = qgap < tgap ? qgap : tgap;
      push(2, qgap - common);                    // I
      push(3, tgap - common);                    // D
      if (common > 0)
        span(q + l + (qgap - common), t + l + (tgap - common), common);
    }
  }
  return overflow ? -1 : n;
}

// Plan indel-refine regions over a segment's block list and classify
// each region in one pass (native mirror of
// align/indel_refine.plan_refine_regions + the trivial-region logic of
// queue_indel_refine_jobs; reference semantics IndelRefine.h:133-230).
//   blocks:  n x 3 int64 (q, t, len), ascending
//   read / chrom: uint8 code arrays (windows indexed absolutely)
//   out: cap rows x 10 int64:
//     lo, hi, trim0, keep1, q0, t0, q1, t1, band, kind
//     kind: 0 = no job (identity fast path / degenerate window),
//           1 = refine-DP job, 2 = tiny-window linear job
// Returns region count, or -1 if cap exceeded.
extern "C" int64_t lrn_plan_indel_regions(
    const int64_t* blocks, int64_t n, const uint8_t* read,
    const uint8_t* chrom, int64_t max_gap, int64_t span_cap,
    int diag_ok, int64_t refine_band, int64_t* out, int64_t cap) {
  const int64_t* Q = blocks;        // stride 3
  int64_t nreg = 0;
  int64_t i = 0, consumed = 0;
  while (i < n) {
    int64_t j = i;
    int64_t eff0 = Q[i * 3 + 2] - consumed;
    int64_t ws = Q[i * 3] + consumed + (eff0 > max_gap ? eff0 - max_gap : 0);
    while (j < n - 1) {
      int64_t q = Q[j * 3], t = Q[j * 3 + 1], ln = Q[j * 3 + 2];
      int64_t qn = Q[(j + 1) * 3], tn = Q[(j + 1) * 3 + 1];
      int64_t ln_n = Q[(j + 1) * 3 + 2];
      int64_t qgap = qn - (q + ln), tgap = tn - (t + ln);
      int64_t span = qn + (ln_n < max_gap ? ln_n : max_gap) - ws;
      if (qgap < max_gap && tgap < max_gap &&
          (j == i || Q[j * 3 + 2] < 100) && span <= span_cap)
        j++;
      else
        break;
    }
    if (j > i) {
      int64_t eff_len = Q[i * 3 + 2] - consumed;
      int64_t trim0 = consumed + (eff_len > max_gap ? eff_len - max_gap : 0);
      int64_t keep1 = Q[j * 3 + 2] < max_gap ? Q[j * 3 + 2] : max_gap;
      // classify
      int64_t q0 = Q[i * 3] + trim0, t0 = Q[i * 3 + 1] + trim0;
      int64_t q1 = Q[j * 3] + keep1, t1 = Q[j * 3 + 1] + keep1;
      int64_t band = 0, kind = 1;
      if (diag_ok) {
        int diagonal = 1;
        for (int64_t b = i; b < j; b++) {
          int64_t qg = Q[(b + 1) * 3] - (Q[b * 3] + Q[b * 3 + 2]);
          int64_t tg = Q[(b + 1) * 3 + 1] - (Q[b * 3 + 1] + Q[b * 3 + 2]);
          if (qg != tg) { diagonal = 0; break; }
        }
        if (diagonal) {
          int64_t mm = 0;
          for (int64_t p = 0; p < q1 - q0 && mm <= 1; p++)
            mm += read[q0 + p] != chrom[t0 + p];
          if (mm <= 1) kind = 0;
        }
      }
      if (kind && (q1 <= q0 || t1 <= t0)) kind = 0;
      if (kind) {
        if (q1 - q0 < refine_band || t1 - t0 < refine_band) {
          kind = 2;
          band = refine_band;
        } else {
          int64_t maxoff = 0;
          for (int64_t b = i; b <= j; b++) {
            int64_t off = (Q[b * 3] - q0) - (Q[b * 3 + 1] - t0);
            if (off < 0) off = -off;
            if (off > maxoff) maxoff = off;
          }
          band = refine_band + maxoff;
        }
      }
      if (nreg >= cap) return -1;
      int64_t* o = out + nreg * 10;
      o[0] = i; o[1] = j; o[2] = trim0; o[3] = keep1;
      o[4] = q0; o[5] = t0; o[6] = q1; o[7] = t1;
      o[8] = band; o[9] = kind;
      nreg++;
      if (Q[j * 3 + 2] > max_gap) { i = j; consumed = max_gap; }
      else { i = j + 1; consumed = 0; }
    } else {
      i++;
      consumed = 0;
    }
  }
  return nreg;
}

// Refine-lane banded DP + lane-aware traceback (C mirror of
// ops/affine_kernel.banded_refine_np + traceback_refine; identical
// recurrence and tie order).  Affine consolidation lanes on top of
// linear single-step gaps: gap open = 2*indel+1, extend = 0 (the
// reference's IndelRefine scoring, IndelRefine.h:339-612).  Used for
// long indel-refine regions (reference groups regions with no span
// cap, IndelRefine.h:147-165) where a device bucket dispatch would be
// a near-empty giant tier; O(tlen * band) with small band.
// Scores are exact in float32 (all integer-valued), matching the numpy
// mirror bit-for-bit including the -1e30 rail absorption semantics.
// Returns n blocks written to blocks_out (int64 triples q,t,len,
// region-local), or -1 if max_blocks too small.
// Shaped-band variant, in two phases: lrn_refine_windows builds the
// per-row q windows, dilated from the region's existing block path
// (the reference's qS/qE construction, IndelRefine.h:219-330, computed
// as a slightly wider superset: path dilated k rows in t and k+1 in q,
// then made monotone like the reference's two passes at :318-325);
// lrn_refine_dp_windowed solves the DP over given windows and walks
// back.  lrn_refine_dp_shaped runs both.  The device kernel
// (csrc/banded_refine.cu, refine_shaped_kernel) solves the windows of
// lrn_refine_windows, so both solvers share one band geometry.  Cost
// O(path_len * (2k+3)) regardless of total diagonal drift — the
// rectangular band pays O(len * 2*(k+drift)) and explores paths the
// reference's shaped band cannot, so this is both the fast and the
// more faithful geometry.

// Row windows of the shaped band: row j (0..tlen) covers q in
// [qlo[j], qhi[j]] (int32, tlen + 1 each), monotone non-decreasing in
// both bounds, with qlo[0] = 0 and qhi[tlen] = qlen.  path_blocks:
// job-local (q,t,len) triples of the region's current alignment (must
// start at (0,0) and end at (qlen,tlen) corners).  Returns the window
// cells (the sum of the widths), or -1 on degenerate input.
int64_t lrn_refine_windows(const int64_t* path_blocks, int64_t npb,
                           int64_t qlen, int64_t tlen, int64_t k,
                           int32_t* qlo, int32_t* qhi) {
  if (tlen < 1 || qlen < 1 || npb < 1) return -1;
  const int32_t MAXI = INT32_MAX, MINI = INT32_MIN;
  const int64_t W = 2 * k + 1;
  const int64_t n_ext = tlen + 1 + 2 * k;
  // thread-local scratch, int32 (a region's coordinates fit): per-row
  // path extents, then van Herk's prefix/suffix extremes over blocks of
  // W rows of the extents padded by k empty rows on each side
  static thread_local std::vector<int32_t> scr_tl;
  const size_t need = (size_t)(2 * (tlen + 1) + 4 * n_ext);
  if (scr_tl.size() < need) scr_tl.resize(need);
  int32_t* const pmin = scr_tl.data();
  int32_t* const pmax = pmin + (tlen + 1);
  int32_t* const pre_min = pmax + (tlen + 1);
  int32_t* const suf_min = pre_min + n_ext;
  int32_t* const pre_max = suf_min + n_ext;
  int32_t* const suf_max = pre_max + n_ext;
  std::fill(pmin, pmin + tlen + 1, MAXI);
  std::fill(pmax, pmax + tlen + 1, MINI);
  // per-row path extent (pmin/pmax over path cells with t == row)
  auto touch = [&](int64_t pi, int64_t pj) {
    if (pj < 0 || pj > tlen) return;
    if (pi < pmin[pj]) pmin[pj] = (int32_t)pi;
    if (pi > pmax[pj]) pmax[pj] = (int32_t)pi;
  };
  for (int64_t b = 0; b < npb; b++) {
    const int64_t bq = path_blocks[b * 3], bt = path_blocks[b * 3 + 1];
    const int64_t ln = path_blocks[b * 3 + 2];
    touch(bq, bt);
    touch(bq + ln, bt + ln);
    if (bt != bt + ln) {  // diagonal run: extremes per row suffice
      for (int64_t p = 1; p < ln; p++) touch(bq + p, bt + p);
    }
    if (b + 1 < npb) {  // gap legs to the next block (L-shaped walk)
      const int64_t qe = bq + ln, te = bt + ln;
      const int64_t qn = path_blocks[(b + 1) * 3];
      const int64_t tn = path_blocks[(b + 1) * 3 + 1];
      for (int64_t p = qe; p <= qn; p++) touch(p, te);   // q leg (row te)
      for (int64_t p = te; p <= tn; p++) touch(qn, p);   // t leg
    }
  }
  touch(0, 0);
  touch(qlen, tlen);
  // row window = own-row path extent dilated k+1 in q, UNION the bare
  // path extents of rows within +-k (the reference's ki loop only
  // extends neighbor rows to the bare q, not q+-k — IndelRefine.h:
  // 263-283); on a diagonal this gives width 2k+3, not 4k+3.
  // van Herk sliding min/max over the +-k row window: O(1) per row
  auto emin = [&](int64_t x) {
    return x >= k && x - k <= tlen ? pmin[x - k] : MAXI;
  };
  auto emax = [&](int64_t x) {
    return x >= k && x - k <= tlen ? pmax[x - k] : MINI;
  };
  for (int64_t x = 0; x < n_ext; x++) {
    pre_min[x] = (x % W) ? std::min(pre_min[x - 1], emin(x)) : emin(x);
    pre_max[x] = (x % W) ? std::max(pre_max[x - 1], emax(x)) : emax(x);
  }
  for (int64_t x = n_ext - 1; x >= 0; x--) {
    const bool edge = (x == n_ext - 1) || ((x + 1) % W == 0);
    suf_min[x] = edge ? emin(x) : std::min(suf_min[x + 1], emin(x));
    suf_max[x] = edge ? emax(x) : std::max(suf_max[x + 1], emax(x));
  }
  int64_t cells = 0;
  for (int64_t j = 0; j <= tlen; j++) {
    // window [j-k, j+k] in original rows = [j, j+2k] in extended
    const int64_t a = j, b = j + 2 * k;
    const int64_t nlo = std::min(suf_min[a], pre_min[b]);
    const int64_t nhi = std::max(suf_max[a], pre_max[b]);
    int64_t lo, hi;
    if (pmin[j] != MAXI) {
      lo = pmin[j] - (k + 1);
      hi = pmax[j] + (k + 1);
    } else {
      lo = INT64_MAX;
      hi = INT64_MIN;
    }
    if (nlo != MAXI) {
      if (nlo - 1 < lo) lo = nlo - 1;
      if (nhi + 1 > hi) hi = nhi + 1;
    }
    if (lo == INT64_MAX) { lo = 0; hi = qlen; }  // empty row: full width
    qlo[j] = (int32_t)(lo < 0 ? 0 : lo);
    qhi[j] = (int32_t)(hi > qlen ? qlen : hi);
  }
  // monotone passes (reference IndelRefine.h:318-325)
  for (int64_t j = tlen; j >= 1; j--)
    if (qlo[j] < qlo[j - 1]) qlo[j - 1] = qlo[j];
  for (int64_t j = 0; j < tlen; j++)
    if (qhi[j] > qhi[j + 1]) qhi[j + 1] = qhi[j];
  qlo[0] = 0;
  if (qhi[tlen] < qlen) qhi[tlen] = (int32_t)qlen;
  for (int64_t j = 0; j <= tlen; j++) cells += qhi[j] - qlo[j] + 1;
  return cells;
}

// The shaped-band DP and traceback over the row windows qlo/qhi of
// lrn_refine_windows (tlen + 1 rows).  Returns blocks written, or -1 on
// overflow/degenerate input.
int64_t lrn_refine_dp_windowed(
    const int8_t* q, int64_t qlen, const int8_t* t, int64_t tlen,
    const int32_t* qlo, const int32_t* qhi, int64_t m, int64_t mm,
    int64_t indel, int64_t* blocks_out, int64_t max_blocks) {
  if (tlen < 1 || qlen < 1) return -1;
  const float NEGF = -1.0e30f;
  const int8_t A_DONE = 0, A_LEFT = 1, A_DOWN = 2, A_DIAG = 3;
  const int8_t A_DELC = 4, A_INSC = 5;
  const int8_t DEL_OPEN = 8, INS_OPEN = 16;
  const float fopen = (float)(2 * indel + 1);
  const float find = (float)indel;

  // flat plane storage with per-row offsets; scratch is thread-local
  // (423 calls per ONT batch — per-call malloc+first-touch of up to
  // ~1MB planes was a measurable share of the host bill)
  std::vector<int64_t> rowoff(tlen + 2);
  rowoff[0] = 0;
  for (int64_t j = 0; j <= tlen; j++)
    rowoff[j + 1] = rowoff[j] + (qhi[j] - qlo[j] + 1);
  static thread_local std::vector<int8_t> planes_tl;
  if ((int64_t)planes_tl.size() < rowoff[tlen + 1])
    planes_tl.resize(rowoff[tlen + 1]);
  std::fill(planes_tl.begin(), planes_tl.begin() + rowoff[tlen + 1], -1);
  int8_t* const planes = planes_tl.data();
  const int64_t maxw = [&] {
    int64_t w = 0;
    for (int64_t j = 0; j <= tlen; j++)
      if (qhi[j] - qlo[j] + 1 > w) w = qhi[j] - qlo[j] + 1;
    return w;
  }();
  static thread_local std::vector<float> scr_tl;
  if ((int64_t)scr_tl.size() < 8 * maxw) scr_tl.resize(8 * maxw);
  float* Sp = scr_tl.data();
  float* Dp = Sp + maxw;
  float* Sn = Dp + maxw;
  float* Dn = Sn + maxw;
  float* baseA = Dn + maxw;
  float* sMatA = baseA + maxw;
  float* delLinA = sMatA + maxw;
  float* irowA = delLinA + maxw;
  std::fill(Sp, Sp + 4 * maxw, NEGF);

  // row 0: free left moves from the origin
  {
    int8_t* arr = &planes[0];
    for (int64_t i = qlo[0]; i <= qhi[0]; i++) {
      Sp[i - qlo[0]] = find * (float)i;
      arr[i - qlo[0]] = i > 0 ? A_LEFT : A_DONE;
    }
  }
  const float fm = (float)m, fmm = (float)mm;
  for (int64_t j = 1; j <= tlen; j++) {
    const int8_t tc = t[j - 1];
    const int64_t lo0 = qlo[j], hi = qhi[j];
    const int64_t plo = qlo[j - 1], phi = qhi[j - 1];
    int8_t* arr = &planes[rowoff[j]];
    // qlo/qhi monotone non-decreasing => lo >= plo, so only the upper
    // bound needs checking on previous-row reads; index by absolute i
    const float* SpP = Sp - plo;
    const float* DpP = Dp - plo;
    float S_left = NEGF;
    float sDiag0 = (lo0 - 1 >= plo && lo0 - 1 <= phi) ? SpP[lo0 - 1] : NEGF;
    int64_t lo = lo0;
    int64_t xoff = 0;
    if (lo == 0) {  // row j >= 1: column 0 is rail
      sDiag0 = (0 <= phi) ? SpP[0] : NEGF;
      Sn[0] = NEGF;
      Dn[0] = NEGF;
      arr[0] = -1;
      lo = 1;
      xoff = 1;
    }
    const int64_t w = hi - lo + 1;
    const int64_t hi_up = hi < phi ? hi : phi;
    const int64_t w_up = hi_up - lo + 1 > 0 ? hi_up - lo + 1 : 0;
    float* __restrict__ Snr = Sn + xoff;
    float* __restrict__ Dnr = Dn + xoff;
    int8_t* __restrict__ arrr = arr + xoff;
    const float* __restrict__ SpR = SpP + lo;    // sUp for x: SpR[x]
    const float* __restrict__ DpR = DpP + lo;
    const int8_t* __restrict__ qR = q + (lo - 1);
    float* __restrict__ baseR = baseA;
    float* __restrict__ sMatR = sMatA;
    float* __restrict__ delLinR = delLinA;
    float* __restrict__ irowR = irowA;
    // pass A0: substitution scores (int8 compare isolated in its own
    // loop — mixed int8/float bodies defeat the autovectorizer)
    float* __restrict__ subR = irowA;  // irowA free until pass B1
    for (int64_t x = 0; x < w; x++)
      subR[x] = (qR[x] == tc) ? fm : fmm;
    // pass A (vectorized: x=0 peeled so the diagonal read is a plain
    // shifted load; __restrict__ because all lanes share one scratch
    // block and gcc otherwise assumes aliasing and stays scalar)
    if (w_up > 0) {
      const float sUp0 = SpR[0];
      const float so0 = sUp0 + fopen;
      const float dn0 = so0 > DpR[0] ? so0 : DpR[0];
      const float sMat0 = sDiag0 + subR[0];
      const float delLin0 = sUp0 + find;
      float b0 = sMat0 > delLin0 ? sMat0 : delLin0;
      if (dn0 > b0) b0 = dn0;
      Dnr[0] = dn0; baseR[0] = b0; sMatR[0] = sMat0; delLinR[0] = delLin0;
    }
    for (int64_t x = 1; x < w_up; x++) {
      const float sUp = SpR[x];
      const float so = sUp + fopen;
      const float dn = so > DpR[x] ? so : DpR[x];
      const float sMat = SpR[x - 1] + subR[x];
      const float delLin = sUp + find;
      float base = sMat > delLin ? sMat : delLin;
      if (dn > base) base = dn;
      Dnr[x] = dn;
      baseR[x] = base;
      sMatR[x] = sMat;
      delLinR[x] = delLin;
    }
    for (int64_t x = w_up; x < w; x++) {   // above the previous window
      const float sMat = (x == w_up && x > 0 ? SpR[x - 1]
                          : (x == 0 ? sDiag0 : NEGF)) + subR[x];
      const float dn = NEGF + fopen;
      float base = sMat > NEGF + find ? sMat : NEGF + find;
      if (dn > base) base = dn;
      Dnr[x] = dn;
      baseR[x] = base;
      sMatR[x] = sMat;
      delLinR[x] = NEGF + find;
    }
    // pass B1 (scalar, minimal carried work): the two running maxima
    // (linear-ins chain L0, open-lane prefix max PM) and the final S
    float L0 = NEGF, PM = NEGF;
    for (int64_t x = 0; x < w; x++) {
      const float base = baseR[x];
      const float l0e = L0 + find;
      L0 = base > l0e ? base : l0e;
      const float irow = PM + fopen;
      PM = base > PM ? base : PM;
      irowR[x] = irow;
      Snr[x] = L0 > irow ? L0 : irow;
    }
    // pass C (vectorizable, no carried deps): branchless arrow
    // selection (reverse-priority cmov chain; data-dependent branches
    // mispredict) — S_left is just Snr[x-1]; split at w_up so the
    // previous-row read needs no mask; x=0 peeled
    if (w > 0) {
      const float s0 = Snr[0];
      int a0 = A_INSC;
      a0 = (s0 == Dnr[0]) ? A_DELC : a0;
      a0 = (s0 == delLinR[0]) ? A_DOWN : a0;
      a0 = (s0 == S_left + find) ? A_LEFT : a0;
      a0 = (s0 == sMatR[0]) ? A_DIAG : a0;
      const float sup0 = 0 < w_up ? SpR[0] : NEGF;
      a0 |= (Dnr[0] == sup0 + fopen) ? DEL_OPEN : 0;
      a0 |= (irowR[0] == S_left + fopen) ? INS_OPEN : 0;
      arrr[0] = (int8_t)a0;
    }
    const int64_t wu1 = w_up < w ? w_up : w;
    for (int64_t x = 1; x < wu1; x++) {
      const float s = Snr[x];
      const float sl = Snr[x - 1];
      int a = A_INSC;
      a = (s == Dnr[x]) ? A_DELC : a;
      a = (s == delLinR[x]) ? A_DOWN : a;
      a = (s == sl + find) ? A_LEFT : a;
      a = (s == sMatR[x]) ? A_DIAG : a;
      a |= (Dnr[x] == SpR[x] + fopen) ? DEL_OPEN : 0;
      a |= (irowR[x] == sl + fopen) ? INS_OPEN : 0;
      arrr[x] = (int8_t)a;
    }
    for (int64_t x = wu1 > 1 ? wu1 : 1; x < w; x++) {
      const float s = Snr[x];
      const float sl = Snr[x - 1];
      int a = A_INSC;
      a = (s == Dnr[x]) ? A_DELC : a;
      a = (s == delLinR[x]) ? A_DOWN : a;
      a = (s == sl + find) ? A_LEFT : a;
      a = (s == sMatR[x]) ? A_DIAG : a;
      a |= (Dnr[x] == NEGF + fopen) ? DEL_OPEN : 0;
      a |= (irowR[x] == sl + fopen) ? INS_OPEN : 0;
      arrr[x] = (int8_t)a;
    }
    std::swap(Sp, Sn);
    std::swap(Dp, Dn);
  }

  // lane-aware traceback over the shaped planes
  int64_t i = qlen, j = tlen;
  int lane = 0;
  std::vector<int8_t> ops;
  ops.reserve((size_t)(qlen + tlen));
  while (i >= 0 && j >= 0) {
    if (i < qlo[j] || i > qhi[j]) break;
    const int8_t p = planes[rowoff[j] + (i - qlo[j])];
    if (p < 0) break;
    const int code = p & 7;
    if (lane == 1 || (lane == 0 && code == A_DELC)) {
      ops.push_back(A_DOWN);
      lane = (p & DEL_OPEN) ? 0 : 1;
      j--;
    } else if (lane == 2 || (lane == 0 && code == A_INSC)) {
      ops.push_back(A_LEFT);
      lane = (p & INS_OPEN) ? 0 : 2;
      i--;
    } else if (code == A_DONE) {
      break;
    } else if (code == A_DIAG) {
      ops.push_back(A_DIAG); i--; j--;
    } else if (code == A_LEFT) {
      ops.push_back(A_LEFT); i--;
    } else if (code == A_DOWN) {
      ops.push_back(A_DOWN); j--;
    } else {
      break;
    }
  }
  return emit_refine_blocks(ops, blocks_out, max_blocks);
}

// Both phases: the windows of path_blocks, then the DP over them.
int64_t lrn_refine_dp_shaped(
    const int8_t* q, int64_t qlen, const int8_t* t, int64_t tlen,
    const int64_t* path_blocks, int64_t npb, int64_t k, int64_t m,
    int64_t mm, int64_t indel, int64_t* blocks_out, int64_t max_blocks) {
  if (tlen < 1 || qlen < 1 || npb < 1) return -1;
  std::vector<int32_t> qlo(tlen + 1), qhi(tlen + 1);
  if (lrn_refine_windows(path_blocks, npb, qlen, tlen, k, qlo.data(),
                         qhi.data()) < 0)
    return -1;
  return lrn_refine_dp_windowed(q, qlen, t, tlen, qlo.data(), qhi.data(), m,
                                mm, indel, blocks_out, max_blocks);
}

int64_t lrn_refine_dp(const int8_t* q, int64_t qlen, const int8_t* t,
                      int64_t tlen, int64_t K, int64_t kband, int64_t m,
                      int64_t mm, int64_t indel, int64_t* blocks_out,
                      int64_t max_blocks) {
  const float NEGF = -1.0e30f;
  const int8_t A_DONE = 0, A_LEFT = 1, A_DOWN = 2, A_DIAG = 3;
  const int8_t A_DELC = 4, A_INSC = 5;
  const int8_t DEL_OPEN = 8, INS_OPEN = 16;
  const float fopen = (float)(2 * indel + 1);
  const float find = (float)indel;
  const int64_t band = 2 * K + 1;
  std::vector<int8_t> planes((size_t)(tlen + 1) * band, -1);
  std::vector<float> Sp(band), Dp(band, NEGF), Srow(band), Dnew(band);
  std::vector<float> sMat(band), delLin(band), Irow(band);
  std::vector<uint8_t> dopen(band), valid(band);

  for (int64_t d = 0; d < band; d++) {
    int64_t off = d - K;
    bool inb = off >= -kband && off <= kband;
    bool ok = inb && off >= 0 && off <= qlen;
    Sp[d] = ok ? find * (float)off : NEGF;
    planes[d] = ok ? (off > 0 ? A_LEFT : A_DONE) : -1;
  }
  for (int64_t j = 1; j <= tlen; j++) {
    const int8_t tc = t[j - 1];
    // pass 1: base (max of diag / linear-del / affine-del-close) + lanes
    float L0 = NEGF, PM = NEGF;
    for (int64_t d = 0; d < band; d++) {
      const int64_t i = j + d - K;
      const int8_t qc = (i - 1 >= 0 && i - 1 < qlen) ? q[i - 1] : (int8_t)5;
      const float sub = (qc == tc) ? (float)m : (float)mm;
      const float shiftS = (d + 1 < band) ? Sp[d + 1] : NEGF;
      const float shiftD = (d + 1 < band) ? Dp[d + 1] : NEGF;
      const float dn = std::max(shiftS + fopen, shiftD);
      Dnew[d] = dn;
      dopen[d] = (dn == shiftS + fopen) ? DEL_OPEN : 0;
      sMat[d] = Sp[d] + sub;
      delLin[d] = shiftS + find;
      float base = std::max(std::max(sMat[d], delLin[d]), dn);
      const int64_t off = d - K;
      const bool ok = (i >= 1 && i <= qlen && off >= -kband && off <= kband);
      valid[d] = ok;
      if (!ok) base = NEGF;
      // ins closures along the row: linear chain + affine (prefix max)
      L0 = std::max(base, L0 + find);
      Irow[d] = PM + fopen;          // PM = max(base[0..d-1])
      PM = std::max(PM, base);
      const float s = ok ? std::max(L0, Irow[d]) : NEGF;
      if (!ok) Irow[d] = NEGF;
      Srow[d] = s;
    }
    // pass 2: arrows with the numpy mirror's exact tie order
    int8_t* arr = &planes[(size_t)j * band];
    for (int64_t d = 0; d < band; d++) {
      if (!valid[d]) { arr[d] = -1; Dp[d] = NEGF; Sp[d] = Srow[d]; continue; }
      const float s = Srow[d];
      const float s_left = (d > 0) ? Srow[d - 1] : NEGF;
      int8_t a;
      if (s == sMat[d]) a = A_DIAG;
      else if (s == s_left + find) a = A_LEFT;
      else if (s == delLin[d]) a = A_DOWN;
      else if (s == Dnew[d]) a = A_DELC;
      else a = A_INSC;
      int8_t bits = dopen[d];
      if (Irow[d] == s_left + fopen) bits |= INS_OPEN;
      arr[d] = (int8_t)(a | bits);
      Dp[d] = Dnew[d];
      Sp[d] = s;
    }
  }

  // lane-aware traceback (mirror of affine_kernel.traceback_refine)
  int64_t i = qlen, j = tlen;
  int lane = 0;  // 0 main, 1 del, 2 ins
  std::vector<int8_t> ops;
  ops.reserve((size_t)(qlen + tlen));
  while (i >= 0 && j >= 0) {
    const int64_t d = i - j + K;
    if (d < 0 || d >= band) break;
    const int8_t p = planes[(size_t)j * band + d];
    if (p < 0) break;
    const int code = p & 7;
    if (lane == 1 || (lane == 0 && code == A_DELC)) {
      ops.push_back(A_DOWN);
      lane = (p & DEL_OPEN) ? 0 : 1;
      j--;
    } else if (lane == 2 || (lane == 0 && code == A_INSC)) {
      ops.push_back(A_LEFT);
      lane = (p & INS_OPEN) ? 0 : 2;
      i--;
    } else if (code == A_DONE) {
      break;
    } else if (code == A_DIAG) {
      ops.push_back(A_DIAG); i--; j--;
    } else if (code == A_LEFT) {
      ops.push_back(A_LEFT); i--;
    } else if (code == A_DOWN) {
      ops.push_back(A_DOWN); j--;
    } else {
      break;
    }
  }
  // ops are end-first; walk them in reverse emitting match-run blocks
  return emit_refine_blocks(ops, blocks_out, max_blocks);
}

}  // extern "C"
