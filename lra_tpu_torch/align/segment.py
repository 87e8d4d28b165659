"""Alignment segment and group containers.

Equivalent of the reference's ``Alignment`` / ``SegAlignmentGroup`` /
``AlignmentsOrder`` (reference: Alignment.h:21-127, 910-1010, 1013-1070),
minus the per-base strings (see align/cigar.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .cigar import AlnStats

FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800


@dataclass
class Segment:
    """One SAM record's alignment: blocks in strand frame, t chrom-local."""
    blocks: list                      # [(q, t, len)] ascending
    strand: int
    chrom: int
    read_len: int
    stats: AlnStats = field(default_factory=AlnStats)
    mapq: int = 0
    is_secondary: bool = False
    is_supplementary: bool = False
    typeofaln: int = 0                # 0 P, 1/2 S, 3 I(nversion)
    value: float = 0.0                # base-level NV
    first_sdp_value: float = 0.0
    second_sdp_value: float = 0.0
    num_anchors0: int = 0
    num_anchors1: int = 0
    order: int = 0
    runtime: int = 0
    md: str = ""                      # MD:Z tag (when opts.print_md)
    # indel-refine region tiling (plan_refine_regions), set by
    # queue_indel_refine_jobs and consumed by splice_refined_blocks
    refine_plan: list = None

    @property
    def qStart(self):
        return self.blocks[0][0] if self.blocks else 0

    @property
    def qEnd(self):
        if not self.blocks:
            return 0
        q, t, ln = self.blocks[-1]
        return q + ln

    @property
    def tStart(self):
        return self.blocks[0][1] if self.blocks else 0

    @property
    def tEnd(self):
        if not self.blocks:
            return 0
        q, t, ln = self.blocks[-1]
        return t + ln

    @property
    def pre_clip(self):
        return self.qStart

    @property
    def suf_clip(self):
        return self.read_len - self.qEnd

    def flag(self) -> int:
        f = 0
        if self.strand == 1:
            f |= FLAG_REVERSE
        if self.is_secondary:
            f |= FLAG_SECONDARY
        if self.is_supplementary:
            f |= FLAG_SUPPLEMENTARY
        return f


@dataclass
class SegGroup:
    """All segments produced from one primary/secondary chain."""
    segments: list = field(default_factory=list)
    value: float = 0.0
    num_anchors0: int = 0
    is_secondary: bool = False

    def finalize(self):
        """reference: SegAlignmentGroup::SetFromSegAlignment."""
        if not self.segments:
            return
        self.value = sum(s.value for s in self.segments)
        self.num_anchors0 = self.segments[0].num_anchors0
        if all(s.is_supplementary for s in self.segments):
            self.segments[0].is_supplementary = False


def order_groups(groups: list) -> list:
    """Rank groups by value then anchors; mark non-best secondary
    (reference: AlignmentsOrder)."""
    order = sorted(range(len(groups)),
                   key=lambda i: (-groups[i].value, -groups[i].num_anchors0))
    for rank, gi in enumerate(order):
        g = groups[gi]
        g.is_secondary = rank > 0
        for s in g.segments:
            s.is_secondary = g.is_secondary
            if g.is_secondary and s.typeofaln != 3:
                s.typeofaln = 2
    return [groups[i] for i in order]
