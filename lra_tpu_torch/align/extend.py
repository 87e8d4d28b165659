"""Linear anchor extension, overlap trimming, same-diagonal merging.

Ports of reference: LinearExtend.h:137-558 (chain overload),
LinearExtend.h:575-657 (``TrimOverlappedAnchors``), LinearExtend.h:658-780
(raw-pairs overload) and LinearExtend.h:796-826 (``MergeMatchesSameDiag``).

Anchor representation after extension (both strands): (qpos, tpos, length)
with read [q, q+len) aligning to chrom-local genome [t, t+len)
(reverse-complemented when strand=1; q stays in forward-read coords).
The reference's reverse-strand bookkeeping (anchor t taken from the
lowest-t match of a merged run, Checkbp walking t downward) is preserved.

The extension walk itself (Checkbp and the two-pointer merge,
LinearExtend.h:50-360) runs in the native host library
(``native.linear_extend``) on 2-bit code arrays.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..cluster.types import Cluster


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
    pts = list(overlap_points or [])
    return native.linear_extend(read, chrom, q, t, strand, K, pts)


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
