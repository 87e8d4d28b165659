"""Global minimizer index.

Equivalent of the reference's ``StoreIndex``/``ReadIndex``/``WriteIndex``
(reference: MMIndex.h:286-424): per-chromosome canonical minimizers are
shifted into global coordinates, sorted by tuple, frequency-filtered
(drop tuples occurring > global_max_freq times, MMIndex.h:332-351), then
thinned per genome window — survivors are ranked frequency-ascending and
each ``global_winsize``-bp window keeps at most
``num_minimizers_per_window`` of them (MMIndex.h:358-376, ``CountSort``
MMIndex.h:258-283).

Everything is dense array code; the built index is three parallel arrays
(tuple, pos, strand) sorted by tuple then position, ready to be sharded or
replicated onto devices.  Serialization uses npz rather than the
reference's raw ``.mms`` struct dump.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.genome import Genome
from ..options import Options
from .minimizers import minimizers


@dataclass
class GlobalIndex:
    k: int
    tuples: np.ndarray    # uint64, sorted ascending (ties: ascending pos)
    pos: np.ndarray       # uint32 global genome position
    strand: np.ndarray    # uint8: 1 if the canonical k-mer is the revcomp
    freqs: np.ndarray     # int32 multiplicity of each surviving tuple

    def __len__(self) -> int:
        return len(self.tuples)

    def lookup_bounds(self, query_tuples: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """For each query tuple, the [lo, hi) range of matching index rows."""
        lo = np.searchsorted(self.tuples, query_tuples, side="left")
        hi = np.searchsorted(self.tuples, query_tuples, side="right")
        return lo, hi

    def save(self, path: str) -> None:
        np.savez(path, k=self.k, tuples=self.tuples, pos=self.pos,
                 strand=self.strand, freqs=self.freqs)

    @classmethod
    def load(cls, path: str) -> "GlobalIndex":
        z = np.load(path)
        return cls(int(z["k"]), z["tuples"], z["pos"], z["strand"], z["freqs"])
    def minimizer_stats(self) -> dict:
        """Distinct/unique counts and mean frequency (reference:
        CalculateMinimizerStats, MMIndex.h:46-67)."""
        n = len(self.tuples)
        if n == 0:
            return {"total": 0, "distinct": 0, "unique": 0, "avg_freq": 0.0}
        is_new = np.concatenate(([True], self.tuples[1:] != self.tuples[:-1]))
        distinct = int(is_new.sum())
        counts = np.diff(np.concatenate((np.nonzero(is_new)[0], [n])))
        unique = int((counts == 1).sum())
        return {"total": n, "distinct": distinct, "unique": unique,
                "avg_freq": float(n / distinct)}


def index_from_arrays(*, k, tuples, pos, strand, freqs) -> GlobalIndex:
    """A GlobalIndex from its fields given as numpy arrays (and k) — e.g.
    those of an index another implementation built, so two pipelines can
    align against the identical index."""
    return GlobalIndex(int(k), np.asarray(tuples, np.uint64),
                       np.asarray(pos, np.uint32),
                       np.asarray(strand, np.uint8),
                       np.asarray(freqs, np.int32))


# genomes beyond this size take the tuple-partitioned build path:
# full-array argsort workspaces (int64 index + mergesort scratch +
# fancy-index copies) peaked at ~60GB RSS for a 3Gb genome (~600M raw
# occurrences); partitioning by tuple range bounds transients to one
# partition's share while staying bit-identical (partitions are
# disjoint tuple ranges processed ascending, stable within)
_PARTITION_THRESHOLD_BP = 256_000_000
_N_PARTITIONS = 32


def build_global_index(genome: Genome, opts: Options,
                       threads: int = 1) -> GlobalIndex:
    k, w = opts.global_k, opts.global_w

    def _one(ci: int):
        start = 0 if ci == 0 else int(genome.ends[ci - 1])
        end = int(genome.ends[ci])
        t, p, s = minimizers(genome.codes[start:end], k, w, canonical=True,
                             exact=opts.exact_ref_minimizers)
        return t, p, s, start

    # per-chromosome extraction is independent; the native extractor is a
    # ctypes call (GIL released), so threads give real parallel build on
    # multi-core hosts.  Results are collected in chromosome order, so the
    # built index is identical at any thread count (test_minimizers).
    if threads > 1 and genome.nseq > 1:
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(max_workers=threads)
        part_iter = ex.map(_one, range(genome.nseq))
    else:
        ex = None
        part_iter = (_one(ci) for ci in range(genome.nseq))

    if genome.total_len > _PARTITION_THRESHOLD_BP:
        # stream chromosome results straight into tuple-range buckets so
        # raw occurrences are held once, not twice
        s_tuples, s_pos, s_strand, s_freq = _sort_filter_partitioned(
            part_iter, k, opts)
        if ex is not None:
            ex.shutdown()
        if len(s_tuples) == 0:
            return GlobalIndex(k, np.zeros(0, np.uint64),
                               np.zeros(0, np.uint32), np.zeros(0, np.uint8),
                               np.zeros(0, np.int32))
    else:
        parts = list(part_iter)
        if ex is not None:
            ex.shutdown()
        total_raw = sum(len(p[0]) for p in parts)
        if total_raw == 0:
            return GlobalIndex(k, np.zeros(0, np.uint64),
                               np.zeros(0, np.uint32), np.zeros(0, np.uint8),
                               np.zeros(0, np.int32))
        tuples = np.concatenate([p[0] for p in parts])
        pos = np.concatenate([p[1].astype(np.int64) + p[3] for p in parts])
        strand = np.concatenate([p[2] for p in parts])
        del parts

        # sort by (tuple, pos): pos is globally ascending before the sort,
        # so a stable tuple-only argsort gives the same deterministic order
        # as lexsort((pos, tuples)) at half the cost (reference sorts by
        # tuple only, MMIndex.h:314)
        order = np.argsort(tuples, kind="stable")
        tuples, pos, strand = tuples[order], pos[order], strand[order]

        # tuple run lengths -> frequency per occurrence
        boundaries = np.concatenate([[True], tuples[1:] != tuples[:-1]])
        run_id = np.cumsum(boundaries) - 1
        run_sizes = np.bincount(run_id)
        freq = run_sizes[run_id].astype(np.int64)

        # frequency filter: drop tuples with multiplicity > global_max_freq
        # (reference: MMIndex.h:335 `if (ne - n > opts.globalMaxFreq)`)
        keep = freq <= opts.global_max_freq
        s_tuples = tuples[keep]
        s_pos = pos[keep].astype(np.uint32)
        s_strand = strand[keep]
        s_freq = freq[keep].astype(np.int32)

    final = _window_thin(s_pos, s_freq, opts)
    return GlobalIndex(k, s_tuples[final], s_pos[final], s_strand[final],
                       s_freq[final])


def _sort_filter_partitioned(part_iter, k: int, opts: Options):
    """Sort + frequency-filter in _N_PARTITIONS disjoint tuple ranges,
    consuming per-chromosome extraction results as a stream.

    Bit-identical to the direct path: partitions are consecutive tuple
    ranges (top bits of the 2k-bit tuple value) processed ascending;
    within a partition the boolean-mask split preserves the original
    (chromosome, position) order, so the per-partition stable sort
    reproduces exactly the slice of the global stable sort.  Frequency
    counts are exact because equal tuples never span partitions.  Peak
    transients drop from full-array scale to one partition's share."""
    shift = max(0, 2 * k - int(_N_PARTITIONS - 1).bit_length())
    buckets: list = [[] for _ in range(_N_PARTITIONS)]
    for t, p, s, start in part_iter:
        pk = (t >> np.uint64(shift)).astype(np.int64)
        order = np.argsort(pk, kind="stable")   # groups ranges, keeps order
        pk_s = pk[order]
        cuts = np.searchsorted(pk_s, np.arange(_N_PARTITIONS + 1))
        gp = p.astype(np.int64) + start
        for b in range(_N_PARTITIONS):
            lo, hi = int(cuts[b]), int(cuts[b + 1])
            if hi > lo:
                sel = order[lo:hi]
                sel.sort()                       # original order within part
                buckets[b].append((t[sel], gp[sel].astype(np.uint32),
                                   s[sel]))
        del t, p, s, gp, pk, pk_s, order
    out_t, out_p, out_s, out_f = [], [], [], []
    for b in range(_N_PARTITIONS):
        if not buckets[b]:
            continue
        t = np.concatenate([x[0] for x in buckets[b]])
        p = np.concatenate([x[1] for x in buckets[b]])
        s = np.concatenate([x[2] for x in buckets[b]])
        buckets[b] = None
        order = np.argsort(t, kind="stable")
        t, p, s = t[order], p[order], s[order]
        del order
        boundaries = np.concatenate([[True], t[1:] != t[:-1]])
        run_id = np.cumsum(boundaries) - 1
        freq = np.bincount(run_id)[run_id]
        keep = freq <= opts.global_max_freq
        out_t.append(t[keep])
        out_p.append(p[keep])
        out_s.append(s[keep])
        out_f.append(freq[keep].astype(np.int32))
    if not out_t:
        return (np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                np.zeros(0, np.uint8), np.zeros(0, np.int32))
    return (np.concatenate(out_t), np.concatenate(out_p),
            np.concatenate(out_s), np.concatenate(out_f))


# survivor counts beyond this take position-chunked window thinning:
# the full-array rank/sort transients (half a dozen int64 vectors of
# n entries each) were the residual RSS spike of a 3Gb build
_THIN_CHUNK_THRESHOLD = 64_000_000


def _window_thin(pos: np.ndarray, freq: np.ndarray, opts: Options):
    """Per-window thinning of the survivors (reference: MMIndex.h:358-376):
    rank survivors by (freq asc, tuple-sorted index desc) — matching
    CountSort's stable placement order — and keep the first
    num_minimizers_per_window per global_winsize genome window.
    Returns a boolean mask over the survivor rows.

    Thinning is independent per genome window, and the rank among
    equal-freq survivors of one window is preserved by any
    order-preserving subset, so large builds process position-range
    chunks (aligned to window boundaries) independently and
    bit-identically, bounding the sort transients to a chunk's share."""
    n = len(pos)
    if n == 0:
        return np.zeros(0, bool)
    if n > _THIN_CHUNK_THRESHOLD:
        winsize = opts.global_winsize
        win_all = pos // np.uint32(winsize)
        minwin = int(win_all.min())
        maxwin = int(win_all.max()) + 1
        span = maxwin - minwin
        nchunks = max(1, (n + _THIN_CHUNK_THRESHOLD // 8 - 1)
                      // (_THIN_CHUNK_THRESHOLD // 8))
        # recursion progress requires the window range to be rebased to
        # the survivors' own [minwin, maxwin) and splittable into >= 2
        # nonoverlapping pieces; a chunk whose survivors all share one
        # window (span 1) falls through to the direct path — with span
        # >= 2 and nchunks >= 2 every chunk range is a strict subset, so
        # each level strictly shrinks and the recursion terminates
        if span >= 2 and nchunks >= 2:
            final = np.zeros(n, bool)
            for c in range(nchunks):
                lo_w = minwin + c * span // nchunks
                hi_w = minwin + (c + 1) * span // nchunks
                sel = np.nonzero((win_all >= lo_w) & (win_all < hi_w))[0]
                if not len(sel):
                    continue
                sub = _window_thin(pos[sel], freq[sel], opts)
                final[sel[sub]] = True
                del sel, sub
            return final
    from .. import native

    # (freq asc, index desc): stable argsort of the reversed array;
    # freq values are small ints, so the native counting sort applies
    rev = np.ascontiguousarray(freq[::-1], np.int32)
    o = native.counting_argsort_i32(rev) if native.available() else None
    if o is None:
        o = np.argsort(rev, kind="stable")
    ranked = n - 1 - o
    win = (pos[ranked] // opts.global_winsize).astype(np.int64)
    # rank of each element within its window, in `ranked` order
    win32 = win.astype(np.int32)
    # cap the counting-sort range: the native sort allocates two
    # int64 vectors of `range` entries (~16B/window), so a 3Gb
    # genome at winsize 12 (~2.6e8 windows) would transiently eat
    # ~4GB; past 1<<26 windows the numpy stable sort is cheaper
    worder = (native.counting_argsort_i32(win32, 1 << 26)
              if native.available() else None)
    if worder is None:
        worder = np.argsort(win, kind="stable")
    wsorted = win[worder]
    wstart = np.concatenate([[True], wsorted[1:] != wsorted[:-1]])
    grp = np.cumsum(wstart) - 1
    first_of_grp = np.nonzero(wstart)[0]
    rank_in_win = np.arange(len(wsorted)) - first_of_grp[grp]
    kept_mask_sorted = rank_in_win < opts.num_minimizers_per_window
    final = np.zeros(n, dtype=bool)
    final[ranked[worder[kept_mask_sorted]]] = True
    return final
