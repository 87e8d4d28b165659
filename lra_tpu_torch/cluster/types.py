"""Cluster containers.

Equivalent of the reference's ``ClusterCoordinates``/``Cluster``
(reference: Clustering.h:14-185,185-360).  Matches are parallel numpy
arrays (qpos, tpos) rather than pair-structs; k-length anchors carry an
optional per-anchor length array once LinearExtend has run.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Cluster:
    qpos: np.ndarray             # int64 read starts of anchors
    tpos: np.ndarray             # int64 global genome starts
    strand: int                  # 0 fwd, 1 rev (rev anchors in fwd-read coords)
    k: int                       # anchor length (uniform until LinearExtend)
    anchorfreq: float = 1.0
    chrom: int = -1
    coarse: int = -1             # index of the originating coarse cluster
    lengths: np.ndarray | None = None  # per-anchor lengths after extension
    # bounding box (reference: SetClusterBoundariesFromMatches)
    qStart: int = 0
    qEnd: int = 0
    tStart: int = 0
    tEnd: int = 0
    # SDP-1 bookkeeping
    value: float = 0.0
    rank: int = -1

    def __len__(self) -> int:
        return len(self.qpos)

    def anchor_lengths(self) -> np.ndarray:
        if self.lengths is not None:
            return self.lengths
        return np.full(len(self.qpos), self.k, dtype=np.int64)

    def set_boundaries(self) -> None:
        """reference: Clustering.h SetClusterBoundariesFromMatches."""
        ln = self.anchor_lengths()
        self.qStart = int(self.qpos.min())
        self.qEnd = int((self.qpos + ln).max())
        self.tStart = int(self.tpos.min())
        self.tEnd = int((self.tpos + ln).max())

    def single_chrom(self, genome) -> bool:
        """False if the box spans a chromosome boundary (then the cluster is
        dropped); sets chrom (reference: Clustering.h CHROMIndex)."""
        if len(self.qpos) == 0:
            return False
        first = int(genome.chrom_of(self.tStart + 1))
        last = int(genome.chrom_of(self.tEnd))
        if first != last:
            return False
        self.chrom = first
        return True
