"""Rough-cluster splitting and unique-stretch fine clustering.

Ports of the reference's host-side clustering surgery:
* ``SplitRoughClustersWithGaps`` (reference: Clustering.h:1359-1433):
  split a diagonal run at >rough_cluster_max_gap jumps, re-merge
  near-diagonal neighbors, drop pieces below min_cluster_size; runs with
  anchorfreq >= 10 pass through unsplit.
* ``StoreFineClusters`` (reference: Clustering.h:892-1331): group matches
  by read position, find stretches of unique (multiplicity-1) read
  minimizers along a diagonal, pick the longest, greedily absorb
  compatible stretches left/right, chain-walk the non-unique anchors in
  the gaps between accepted stretches, and emit leftover unaccepted
  stretches >= 15 groups as their own clusters.
* ``MatchesToFineClusters`` (reference: Clustering.h:1555-1680) /
  ``CleanMatches`` (reference: Clustering.h:1840-1908): orchestration for
  the high-accuracy / low-accuracy paths.

All of this is small-N ragged bookkeeping — deliberately host code; the
device handles the dense numeric stages on either side.
"""

from __future__ import annotations

import numpy as np

from ..options import Options
from .clean import clean_off_diagonal, diagonal_sort, runs_to_clusters
from .types import Cluster


def _diag_diff(q1, t1, q2, t2, strand):
    if strand == 0:
        return (t1 - q1) - (t2 - q2)
    return (q1 + t1) - (q2 + t2)


def _min_gap(q1, t1, q2, t2):
    return min(abs(int(q2) - int(q1)), abs(int(t2) - int(t1)))


def cartesian_sort_idx(qpos, tpos, idx):
    """Sort match indices by (q, t) (reference: Sorting.h CartesianSort)."""
    return idx[np.lexsort((tpos[idx], qpos[idx]))]


def split_rough_clusters(qpos, tpos, run_slices, run_freqs, opts: Options,
                         k: int, strand: int, genome):
    """run_slices: list of (start, end) into the diagonal-sorted cleaned
    arrays.  Returns list of (match_index_array, anchorfreq, coarse_id),
    each cartesian-sorted."""
    out = []
    for coarse_id, ((s, e), freq) in enumerate(zip(run_slices, run_freqs)):
        if e - s == 0:
            continue
        idx = cartesian_sort_idx(qpos, tpos, np.arange(s, e))
        if freq >= 10.0:
            out.append((idx, freq, coarse_id))
            continue
        # vectorized min-gap split (the per-pair Python loop dominated
        # the anchors+clusters stage)
        qi = qpos[idx].astype(np.int64)
        ti = tpos[idx].astype(np.int64)
        gaps = np.minimum(np.abs(np.diff(qi)), np.abs(np.diff(ti)))
        bounds = np.concatenate(
            ([0], np.nonzero(gaps > opts.rough_cluster_max_gap)[0] + 1,
             [len(idx)]))
        pieces = [(int(bounds[i]), int(bounds[i + 1]))
                  for i in range(len(bounds) - 1)
                  if bounds[i + 1] - bounds[i] >= opts.min_cluster_size]
        # re-merge near-diagonal neighbors (reference: CloseToPreviousCluster)
        merged = []
        for (a, b) in pieces:
            if merged:
                pa, pb = merged[-1]
                q_prev_end = int((qpos[idx[pa:pb]] + k).max())
                t_prev = (int((tpos[idx[pa:pb]] + k).max()) if strand == 0
                          else int(tpos[idx[pa:pb]].min()))
                qS = int(qpos[idx[a]])
                tS = int(tpos[idx[a:b]].min())
                tE = int((tpos[idx[a:b]] + k).max())
                a_diff = abs(qS - q_prev_end)
                b_diff = abs(tS - t_prev) if strand == 0 else abs(t_prev - tE)
                if strand == 0:
                    a_diag = t_prev - q_prev_end
                    b_diag = tS - qS
                else:
                    a_diag = q_prev_end + t_prev
                    b_diag = qS + tE
                if (min(a_diff, b_diff) <= opts.rough_cluster_max_gap
                        and abs(a_diag - b_diag) < opts.max_diag):
                    merged[-1] = (pa, b)
                    continue
            merged.append((a, b))
        for (a, b) in merged:
            out.append((idx[a:b], freq, coarse_id))
    return out


def store_fine_clusters(match_idx, qpos, tpos, anchorfreq, opts: Options,
                        k: int, strand: int, genome, coarse_id: int) -> list:
    """reference: Clustering.h:892-1331.  match_idx is cartesian-sorted."""
    clusters: list = []
    n = len(match_idx)
    if n <= 1:
        return clusters
    q = qpos[match_idx]
    t = tpos[match_idx]

    def emit(rows, freq):
        c = Cluster(q[rows].copy(), t[rows].copy(), strand, k,
                    anchorfreq=freq, coarse=coarse_id)
        c.set_boundaries()
        return c

    def chrom_parts(c: Cluster) -> list:
        """The cluster, split at chromosome boundaries of the concatenated
        coordinate space.  A junction-contiguous read forms ONE diagonal
        run across two chromosomes; the reference drops such clusters
        whole (Clustering.h CHROMIndex) — splitting keeps both sides."""
        if c.single_chrom(genome):
            return [c]
        ci = np.searchsorted(genome.ends, c.tpos, side="right")
        ce = np.searchsorted(genome.ends, c.tpos + c.k - 1, side="right")
        parts = []
        for u in np.unique(ci):
            rows = (ci == u) & (ce == u)   # drop junction-crossing anchors
            if not rows.any():
                continue
            p = Cluster(c.qpos[rows].copy(), c.tpos[rows].copy(), c.strand,
                        c.k, c.anchorfreq, coarse=coarse_id)
            p.set_boundaries()
            if p.single_chrom(genome):
                parts.append(p)
        return parts

    def checks_pass(c: Cluster, min_size=None) -> bool:
        if min_size is not None and len(c) <= min_size:
            return False
        if c.qEnd == c.qStart:
            return False
        return True

    if abs(anchorfreq - 1.0) <= 0.005:
        clusters.extend(chrom_parts(emit(np.arange(n), 1.0)))
        return clusters

    # group by read position (match_num / pos_start)
    gb = np.concatenate([[True], q[1:] != q[:-1]])
    pos_start = np.nonzero(gb)[0]
    match_num = np.diff(np.concatenate([pos_start, [n]]))
    G = len(pos_start)

    # stretches of unique groups along a diagonal
    Start, End = [], []
    u_maxstart = u_maxend = 0
    max_pos = 0
    if G == 1:
        Start, End = [0], [1]
        u_maxstart, u_maxend = 0, 1
    else:
        kk = 0
        while kk < G - 1:
            while kk < G - 1 and match_num[kk] != 1:
                kk += 1
            u_start, u_end = kk, kk + 1
            while (kk < G - 1 and match_num[kk + 1] == match_num[kk]
                   and abs(_diag_diff(q[pos_start[kk + 1]], t[pos_start[kk + 1]],
                                      q[pos_start[kk]], t[pos_start[kk]],
                                      strand)) < opts.max_diag
                   and _min_gap(q[pos_start[kk]], t[pos_start[kk]],
                                q[pos_start[kk + 1]], t[pos_start[kk + 1]])
                   <= opts.max_gap):
                u_end = kk + 2
                kk += 1
            Start.append(u_start)
            End.append(u_end)
            kk += 1
            if (u_maxstart == 0 and u_maxend == 0) or \
               (u_maxend - u_maxstart < u_end - u_start):
                u_maxstart, u_maxend = u_start, u_end
                max_pos = len(Start) - 1

    if u_maxstart == 0 and u_maxend == 0:
        return clusters
    c_s = int(pos_start[u_maxstart])
    c_e = int(pos_start[u_maxend - 1]) + 1

    if not (c_e - c_s >= opts.min_unique_stretch_num
            and q[c_e - 1] + k - q[c_s] >= opts.min_unique_stretch_dist):
        return clusters

    S = len(Start)
    added = np.zeros(S, dtype=bool)
    rows: list = []

    if c_e - c_s == n:
        rows = list(range(c_s, c_e))
        added[0] = True
    else:
        # absorb stretches left of max_pos
        accepted = [max_pos]
        added[max_pos] = True
        prev_anchor = c_s
        for i in range(max_pos - 1, -1, -1):
            i_m = int(pos_start[End[i] - 1])
            dd = abs(_diag_diff(q[i_m], t[i_m], q[prev_anchor],
                                t[prev_anchor], strand))
            mg = _min_gap(q[i_m], t[i_m], q[prev_anchor], t[prev_anchor])
            if (dd <= opts.max_diag and mg <= opts.max_gap) or \
               mg <= opts.max_gap // 2:
                accepted.append(i)
                added[i] = True
                prev_anchor = int(pos_start[Start[i]])
        # absorb stretches right of max_pos
        prev_anchor = c_e - 1
        right = []
        for i in range(max_pos + 1, S):
            i_m = int(pos_start[Start[i]])
            dd = abs(_diag_diff(q[i_m], t[i_m], q[prev_anchor],
                                t[prev_anchor], strand))
            mg = _min_gap(q[i_m], t[i_m], q[prev_anchor], t[prev_anchor])
            if (dd <= opts.max_diag and mg <= opts.max_gap) or \
               mg <= opts.max_gap // 2:
                right.append(i)
                added[i] = True
                prev_anchor = int(pos_start[End[i] - 1])
        accepted = sorted(accepted + right)

        prev_stretch = -1
        for pos_in_list, sid in enumerate(accepted):
            cs_i = int(pos_start[Start[sid]])
            ce_i = int(pos_start[End[sid] - 1]) + 1
            if pos_in_list == 0:
                p_s = 0 if sid == 0 else int(pos_start[End[sid - 1]]) \
                    if End[sid - 1] < G else n
                p_e = cs_i
            else:
                p_s = int(pos_start[End[prev_stretch]]) \
                    if End[prev_stretch] < G else n
                p_e = cs_i
            prev_stretch = sid
            # chain-walk backward through the gap region
            chain = []
            prev_match = cs_i
            for si in range(p_e - 1, p_s - 1, -1):
                if abs(_diag_diff(q[si], t[si], q[prev_match], t[prev_match],
                                  strand)) < opts.max_diag:
                    chain.append(si)
                    prev_match = si
            rows.extend(chain[::-1])
            rows.extend(range(cs_i, ce_i))
            # right-end extension after the last accepted stretch
            if pos_in_list == len(accepted) - 1:
                p_s2 = int(pos_start[End[sid] - 1]) + 1
                p_e2 = n if sid == S - 1 else int(pos_start[Start[sid + 1]])
                prev_match = ce_i - 1
                for si in range(p_s2, p_e2):
                    if abs(_diag_diff(q[si], t[si], q[prev_match],
                                      t[prev_match], strand)) < opts.max_diag:
                        rows.append(si)
                        prev_match = si

    for c in chrom_parts(emit(np.array(rows, dtype=np.int64), anchorfreq)):
        if checks_pass(c, min_size=opts.min_cluster_size) and \
           (c.tEnd - c.tStart) < 5 * (c.qEnd - c.qStart):
            clusters.append(c)

    # leftover stretches of >= 15 groups become their own clusters
    for ar in range(S):
        if not added[ar] and End[ar] - Start[ar] >= 15:
            lo = int(pos_start[Start[ar]])
            hi = int(pos_start[End[ar] - 1]) + 1
            for c in chrom_parts(emit(np.arange(lo, hi), anchorfreq)):
                if (c.tEnd - c.tStart) // max(1, c.qEnd - c.qStart) < 5:
                    clusters.append(c)
    return clusters


def matches_to_fine_clusters(qpos, tpos, opts: Options, genome, k: int,
                             strand: int = 0) -> list:
    """High-accuracy path: sort -> clean -> rough split -> fine clusters
    (reference: Clustering.h:1555-1680)."""
    order = diagonal_sort(qpos, tpos, strand)
    qs, ts = qpos[order], tpos[order]
    keep, run_id, run_freq = clean_off_diagonal(qs, ts, opts, strand)
    if len(keep) == 0:
        return []
    qk, tk = qs[keep], ts[keep]
    # run slices in the cleaned arrays
    b = np.concatenate([[True], run_id[1:] != run_id[:-1]])
    starts = np.nonzero(b)[0]
    ends = np.concatenate([starts[1:], [len(keep)]])
    run_slices = list(zip(starts.tolist(), ends.tolist()))
    freqs = [float(run_freq[s]) for s in starts]

    splits = split_rough_clusters(qk, tk, run_slices, freqs, opts, k,
                                  strand, genome)
    clusters: list = []
    for (idx, freq, coarse_id) in splits:
        clusters.extend(store_fine_clusters(idx, qk, tk, freq, opts, k,
                                            strand, genome, coarse_id))
    return clusters


def clean_matches_to_clusters(qpos, tpos, opts: Options, genome, k: int,
                              strand: int = 0) -> list:
    """Low-accuracy path: sort -> clean -> runs become clusters directly
    (reference: Clustering.h:1840-1908 with ExtractDiagonalFromClean)."""
    order = diagonal_sort(qpos, tpos, strand)
    qs, ts = qpos[order], tpos[order]
    keep, run_id, run_freq = clean_off_diagonal(qs, ts, opts, strand)
    return runs_to_clusters(qs, ts, keep, run_id, run_freq, k, strand, genome)
