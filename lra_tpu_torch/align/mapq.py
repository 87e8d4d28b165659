"""MAPQ assignment (reference: Mapping_ultility.h:497-590 ``SimpleMapQV``).

minimap2-style: pen_cm * q_coef * log(value/k) * identity, scaled by the
best/second-best value ratio and anchor-count ratio, multi-hit penalty
-4.343*ln(#alignments), clamped [0, 60]; read-type-specific q_coef.
"""

from __future__ import annotations

import math

from ..options import Options, ReadType


def _pen_cm(n0: int, bypass: bool) -> float:
    if not bypass:
        p = (1.0 if n0 > 20 else 0.05) * n0
        return (1.0 if n0 >= 5 else 0.1) * p
    p = (1.0 if n0 > 10 else 0.05) * n0
    return (1.0 if n0 >= 5 else 0.02) * p


def _identity(seg) -> float:
    errs = seg.stats.nmm + seg.stats.ndel + seg.stats.nins
    if errs == 0:
        return 1.0
    return min(1.0, seg.stats.nm / errs)


def set_mapq(groups: list, opts: Options) -> None:
    """groups: ordered SegGroups (best first)."""
    if not groups:
        return
    if opts.bypass_clustering and opts.read_type == ReadType.CLR:
        q_coef = 4.0
    elif opts.bypass_clustering and opts.read_type == ReadType.ONT:
        q_coef = 30.0
    else:
        q_coef = 1.0
    n = len(groups)
    for r, g in enumerate(groups):
        if r > 0:
            for s in g.segments:
                s.mapq = 0
            continue
        if n == 1:
            for s in g.segments:
                pen = _pen_cm(s.num_anchors0, opts.bypass_clustering)
                ident = _identity(s)
                l = math.log(s.value / opts.global_k) if s.value > 3 else 0.0
                if not opts.bypass_clustering:
                    mapq = int(pen * q_coef * l * ident)
                else:
                    mapq = int(pen * q_coef * ident)
                s.mapq = max(0, min(60, mapq))
        else:
            x = groups[1].value / g.value if g.value else 1.0
            for s in g.segments:
                pen = _pen_cm(s.num_anchors0, opts.bypass_clustering)
                ident = _identity(s)
                l = math.log(s.value / opts.global_k) if s.value > 3 else 0.0
                y = 1.0
                if opts.bypass_clustering and groups[1].num_anchors0:
                    y = g.num_anchors0 / groups[1].num_anchors0
                if x >= 0.990:
                    mapq = int(pen * (1.0 - x) * y * ident)
                elif not opts.bypass_clustering:
                    mapq = int(pen * q_coef * (1.0 - x) * l * y * ident)
                else:
                    mapq = int(pen * q_coef * (1.0 - x) * y * ident)
                mapq -= int(4.343 * math.log(n) + 0.499)
                mapq = max(0, min(60, mapq))
                if n == 2 and mapq == 0:
                    mapq = 1
                s.mapq = mapq
