"""Linear anchor extension, overlap trimming, same-diagonal merging.

Ports of reference: LinearExtend.h:137-558 (chain overload),
LinearExtend.h:575-657 (``TrimOverlappedAnchors``), LinearExtend.h:658-780
(raw-pairs overload) and LinearExtend.h:796-826 (``MergeMatchesSameDiag``).

Anchor representation after extension (both strands): (qpos, tpos, length)
with read [q, q+len) aligning to chrom-local genome [t, t+len)
(reverse-complemented when strand=1; q stays in forward-read coords).
The reference's reverse-strand bookkeeping (anchor t taken from the
lowest-t match of a merged run, Checkbp walking t downward) is preserved.

Base comparisons run on 2-bit code arrays; per-run comparisons are numpy
slice equality — no per-base Python loop.
"""

from __future__ import annotations

import numpy as np

from ..cluster.types import Cluster
from ..options import Options


def _first_mismatch_fwd(read, chrom, q0, t0, q_hi, t_hi):
    """Bases compared from (q0, t0) diagonally until mismatch or bounds;
    returns #matching bases (reference: Checkbp, LinearExtend.h:50-73)."""
    n = min(q_hi - q0, t_hi - t0)
    if n <= 0:
        return 0
    a = read[q0:q0 + n]
    b = chrom[t0:t0 + n]
    neq = np.nonzero(a != b)[0]
    return int(neq[0]) if len(neq) else n


def _first_mismatch_rev(read, chrom, q0, t0, q_hi):
    """Reverse-strand extension: read forward from q0, genome backward
    from t0.  The comparison is RAW (uncomplemented) byte equality —
    the reference's Checkbp rev loop compares
    ``genome.seqs[curT] == read.seq[curQ]`` with no complement
    (LinearExtend.h:77-82), so rev-strand runs extend only on
    coincidental raw equality; complementing here extended one base
    further and shifted equal-score D-run placements (measured
    bit-identity residual)."""
    n = min(q_hi - q0, t0 + 1)
    if n <= 0:
        return 0
    a = read[q0:q0 + n]
    b = chrom[t0 - n + 1:t0 + 1][::-1]
    neq = np.nonzero(a != b)[0]
    return int(neq[0]) if len(neq) else n


def linear_extend_cluster(cluster: Cluster, read: np.ndarray,
                          chrom: np.ndarray, K: int,
                          overlap_points=None):
    """Extend one cluster's k-length anchors into maximal exact matches.

    cluster.tpos must be chrom-local.  overlap_points: iterable of
    (coord, is_t) boundary points from neighbor clusters; anchors containing
    one are emitted as bare K anchors and break runs
    (reference: CheckOverlap, LinearExtend.h:89-105).

    Returns (qpos, tpos, lengths, overlap_flags) arrays.
    """
    n = len(cluster)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy(), np.zeros(0, bool)
    strand = cluster.strand
    # diagonal sort (fwd: q-t, q; rev: q+t, q)
    if strand == 0:
        order = np.lexsort((cluster.qpos, cluster.qpos - cluster.tpos))
    else:
        order = np.lexsort((cluster.qpos, cluster.qpos + cluster.tpos))
    q = cluster.qpos[order]
    t = cluster.tpos[order]
    qlen = len(read)
    tlen = len(chrom)

    pts = list(overlap_points or [])

    from .. import native
    if native.available():
        return native.linear_extend(read, chrom, q, t, strand, K, pts)

    def has_overlap(i):
        for (coord, is_t) in pts:
            if not is_t and q[i] <= coord < q[i] + K:
                return True
            if is_t and t[i] <= coord < t[i] + K:
                return True
        return False

    out_q, out_t, out_len, out_ovp = [], [], [], []

    def emit_run(m, last, ext_q_end=None, ext_t_end=None):
        """Emit merged anchor for run [m..last] (indices), possibly with a
        partial extension past its end."""
        if strand == 0:
            qe = ext_q_end if ext_q_end is not None else q[last] + K
            out_q.append(q[m])
            out_t.append(t[m])
            out_len.append(qe - q[m])
        else:
            qe = ext_q_end if ext_q_end is not None else q[last] + K
            te = ext_t_end if ext_t_end is not None else t[last]
            out_q.append(q[m])
            out_t.append(te)
            out_len.append(qe - q[m])
        out_ovp.append(False)

    # faithful two-pointer walk (reference: LinearExtend.h:218-360)
    m = 0
    i = 1
    chm = True
    while i < n:
        if chm and has_overlap(m):
            out_q.append(q[m]); out_t.append(t[m])
            out_len.append(K); out_ovp.append(True)
            m = i
            i += 1
            chm = True
            continue
        if has_overlap(i):
            emit_run(m, i - 1)
            out_q.append(q[i]); out_t.append(t[i])
            out_len.append(K); out_ovp.append(True)
            m = i + 1
            i = m + 1
            chm = True
            continue
        if strand == 0:
            same_diag = (q[i - 1] - t[i - 1]) == (q[i] - t[i])
        else:
            same_diag = (q[i - 1] + t[i - 1]) == (q[i] + t[i])
        if same_diag:
            if q[i] < q[i - 1] + K:
                i += 1          # overlapping same-diag anchors: absorb
            elif strand == 0:
                # literal extension from end of anchor i-1 toward anchor i
                ext = _first_mismatch_fwd(read, chrom, q[i - 1] + K,
                                          min(tlen, t[i - 1] + K),
                                          q[i], min(tlen, t[i]))
                qe = q[i - 1] + K + ext
                if qe == q[i]:
                    i += 1       # reached the next anchor: merge
                else:
                    emit_run(m, i - 1, ext_q_end=qe)
                    m = i
                    i += 1
            else:
                ext = _first_mismatch_rev(read, chrom, q[i - 1] + K,
                                          min(tlen - 1, t[i - 1] - 1),
                                          q[i])
                qe = q[i - 1] + K + ext
                te_final = t[i - 1] - 1 - ext  # first unmatched genome pos
                # merge iff extension reaches the next anchor exactly
                # (reference: qe==next.q and te==next.t+K-1)
                if qe == q[i] and te_final == t[i] + K - 1:
                    i += 1
                else:
                    emit_run(m, i - 1, ext_q_end=qe, ext_t_end=te_final + 1)
                    m = i
                    i += 1
        else:
            emit_run(m, i - 1)
            m = i
            i += 1
        chm = False

    if m < n:
        emit_run(m, n - 1)

    return (np.asarray(out_q, np.int64), np.asarray(out_t, np.int64),
            np.asarray(out_len, np.int64), np.asarray(out_ovp, bool))


def trim_overlapped_anchors(qpos, tpos, lengths, strand: int):
    """Trim <=30bp overlaps between long (>=40bp) adjacent anchors in place
    (reference: TrimOverlappedAnchors, LinearExtend.h:575-657)."""
    long_idx = np.nonzero(lengths >= 40)[0]
    if len(long_idx) < 2:
        return
    # cartesian sort of the long anchors: (q, t) fwd; (-q?...) reference
    # LongAnchors sort is by (q then t) for fwd and by reversed-q for rev
    if strand == 0:
        order = long_idx[np.lexsort((tpos[long_idx], qpos[long_idx]))]
    else:
        order = long_idx[np.lexsort((tpos[long_idx], -(qpos[long_idx] +
                                                       lengths[long_idx])))]
    for ln in range(1, len(order)):
        prev, cur = order[ln - 1], order[ln]
        ovp_r = 0
        ovp_g = 0
        if strand == 0:
            pe = qpos[prev] + lengths[prev]
            if pe - 30 <= qpos[cur] < pe:
                ovp_r = int(pe - qpos[cur])
        else:
            ce = qpos[cur] + lengths[cur]
            if qpos[prev] < ce <= qpos[prev] + 30:
                ovp_r = int(ce - qpos[prev])
        te = tpos[prev] + lengths[prev]
        if te - 30 <= tpos[cur] < te:
            ovp_g = int(te - tpos[cur])
        if ovp_r > 0 or ovp_g > 0:
            ovp = max(ovp_r, ovp_g)
            if strand == 1:
                qpos[prev] += ovp + 1
            lengths[prev] -= ovp + 1


def merge_same_diag(qpos, tpos, lengths, overlap, strand: int,
                    merge_dist: int):
    """Group same-diagonal anchors <= merge_dist apart (reference:
    MergeMatchesSameDiag, LinearExtend.h:796-826).  Returns (start, end)
    group slices into the anchor arrays."""
    n = len(qpos)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    q = np.asarray(qpos, np.int64)
    t = np.asarray(tpos, np.int64)
    ln = np.asarray(lengths, np.int64)
    ov = np.asarray(overlap, bool)
    d = t - q if strand == 0 else q + t + ln
    qe = q + ln
    # the reference walks matches in their stored (q-ascending) order and
    # compares each anchor to its IMMEDIATE predecessor in that walk
    # (prev_diag/prev_qEnd update every step, LinearExtend.h:804-821), so
    # two same-diag anchors with an off-diagonal anchor between them in q
    # order never merge; our diag-primary input order makes them adjacent,
    # so adjacency in the q-walk must be required explicitly (measured
    # bit-identity residual: a cross-merged group absorbed the q-span of
    # an off-diag 59bp anchor and SDP-2 dropped the anchor)
    rank = np.empty(n, np.int64)
    rank[np.lexsort((t, q))] = np.arange(n)
    # anchor i chains onto i-1 when q-walk-adjacent, same diagonal, no
    # overlap flags, a positive q gap, and gap <= merge_dist; groups are
    # maximal runs
    chain = (~ov[:-1] & ~ov[1:] & (d[1:] == d[:-1]) & (qe[:-1] < q[1:])
             & (np.abs(q[1:] - qe[:-1]) <= merge_dist)
             & (rank[1:] == rank[:-1] + 1))
    starts = np.concatenate([[0], np.flatnonzero(~chain) + 1]) \
        .astype(np.int64)
    ends = np.concatenate([starts[1:], [n]]).astype(np.int64)
    return starts, ends
