"""Cluster splitting on projected boundaries (SDP-1 input prep).

Port of reference: SplitClusters.h:63-252 (``SplitClusters`` +
``DecideSplitClustersValue``).  Every cluster's q/t boundary coordinates
are projected onto every other cluster via its box's line model
(slope/intercept, negated slope for reverse strand); each crossing cuts
the cluster.  Split pieces carry ``coarse`` back-pointers and a value =
the coarse cluster's matched-base count prorated by length.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..options import Options, ReadType
from .types import Cluster


@dataclass
class SplitCluster:
    qStart: int
    qEnd: int
    tStart: int
    tEnd: int
    strand: int
    coarse: int
    value: float = 0.0
    num_anchors: int = 0


def split_clusters(clusters: list, opts: Options) -> list:
    split: list[SplitCluster] = []
    do_split = []
    qset: set = set()
    tset: set = set()
    for m, c in enumerate(clusters):
        contig_exempt = (
            opts.read_type == ReadType.CONTIG
            and not (c.anchorfreq <= 3.0
                     or (c.anchorfreq <= 5.0
                         and max(c.tEnd - c.tStart, c.qEnd - c.qStart) <= 2000)))
        if contig_exempt:
            do_split.append(False)
            split.append(SplitCluster(c.qStart, c.qEnd, c.tStart, c.tEnd,
                                      c.strand, m))
        else:
            do_split.append(True)
            qset.update((c.qStart, c.qEnd))
            tset.update((c.tStart, c.tEnd))

    qarr = np.array(sorted(qset), dtype=np.int64)
    tarr = np.array(sorted(tset), dtype=np.int64)

    for m, c in enumerate(clusters):
        if not do_split[m]:
            continue
        qspan = c.qEnd - c.qStart
        slope = (c.tEnd - c.tStart) / qspan if qspan else 0.0
        if c.strand == 0:
            inter = ((c.qEnd * c.tStart - c.qStart * c.tEnd) / (c.qEnd - c.qStart)
                     if qspan else 0.0)
        else:
            slope = -slope
            inter = ((c.qStart * c.tStart - c.qEnd * c.tEnd)
                     / (c.qStart - c.qEnd) if qspan else 0.0)

        qcuts = qarr[(qarr > c.qStart) & (qarr < c.qEnd)]
        tcuts = tarr[(tarr > c.tStart) & (tarr < c.tEnd)]
        # sort cut events along q via the line model (reference IntervalSet)
        events = [(int(x), 0) for x in qcuts] + [(int(x), 1) for x in tcuts]

        def q_of(ev):
            coord, is_t = ev
            if not is_t:
                return float(coord)
            return (coord - inter) / slope if slope else float("inf")

        events.sort(key=q_of)

        prev_q = c.qStart
        prev_t = c.tStart if c.strand == 0 else c.tEnd

        def push(q_hi, t_hi):
            nonlocal prev_q, prev_t
            if c.strand == 0:
                if q_hi >= prev_q + 3 and t_hi >= prev_t + 3:
                    split.append(SplitCluster(int(prev_q), int(q_hi),
                                              int(prev_t), int(t_hi),
                                              c.strand, m))
            else:
                if q_hi >= prev_q + 3 and prev_t >= t_hi + 3:
                    split.append(SplitCluster(int(prev_q), int(q_hi),
                                              int(t_hi), int(prev_t),
                                              c.strand, m))

        for (coord, is_t) in events:
            if not is_t:
                t = math.ceil(slope * coord + inter)
                if prev_q < coord:
                    push(coord, t)
                else:
                    continue
                prev_q, prev_t = coord, t
            else:
                qq = math.ceil((coord - inter) / slope) if slope else prev_q
                if prev_q < qq:
                    push(qq, coord)
                else:
                    continue
                prev_q, prev_t = qq, coord

        if prev_q < c.qEnd:
            if c.strand == 0:
                push(c.qEnd, c.tEnd)
            else:
                push(c.qEnd, c.tStart)
    return split


def decide_split_values(clusters: list, split: list, opts: Options) -> None:
    """reference: SplitClusters.h:176-252.  Cluster value = matched bases
    (overlap-aware), split value prorated by min-span ratio; per-split
    anchor counts by q-range."""
    vals = np.zeros(len(clusters))
    for m, c in enumerate(clusters):
        if len(c) == 0:
            continue
        ln = c.anchor_lengths()
        # matched bases with overlap dedup along q: each anchor counts
        # its length minus the overlap with its predecessor's end
        q = c.qpos
        ends = q + ln
        prev_end = np.concatenate([q[:1], ends[:-1]])
        total = int(np.where(prev_end > q, ends - prev_end, ln).sum())
        vals[m] = total
        c.value = total

    for sc in split:
        c = clusters[sc.coarse]
        denom = min(c.qEnd - c.qStart, c.tEnd - c.tStart)
        pika = (min(sc.qEnd - sc.qStart, sc.tEnd - sc.tStart) / denom
                if denom else 0.0)
        sc.value = int(vals[sc.coarse]) * pika

    # anchors per split piece (within the same coarse cluster, by qStart)
    for i, sc in enumerate(split):
        c = clusters[sc.coarse]
        lo = np.searchsorted(c.qpos, sc.qStart, side="left")
        hi = np.searchsorted(c.qpos, sc.qEnd, side="left")
        sc.num_anchors = int(hi - lo)
