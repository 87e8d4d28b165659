"""Genome container with the global-offset coordinate map.

Equivalent of the reference's ``Genome`` + ``Header``
(reference: Genome.h:13-90 Header, Genome.h:115-138 Genome::Read): all
chromosomes are concatenated into one coordinate space; ``ends[i]`` is the
global offset one past chromosome i (reference ``Header.pos``).  The whole
genome is held as one uint8 2-bit code array, which is what the device
kernels consume.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import seq as sequtils
from .fasta import read_fasta


@dataclass
class Genome:
    names: list
    ends: np.ndarray        # int64, len = n_chroms; ends[i] = global end of chrom i
    codes: np.ndarray       # uint8 2-bit codes of the concatenated genome

    @property
    def nseq(self) -> int:
        return len(self.names)

    @property
    def total_len(self) -> int:
        return int(self.ends[-1]) if len(self.ends) else 0

    def starts(self) -> np.ndarray:
        if getattr(self, "_starts", None) is None:
            self._starts = np.concatenate([[0], self.ends[:-1]])
        return self._starts

    def chrom_of(self, gpos) -> np.ndarray:
        """Global position(s) -> chromosome index (reference: Genome.h Header::Find)."""
        return np.searchsorted(self.ends, gpos, side="right")

    def local_pos(self, gpos):
        ci = self.chrom_of(gpos)
        return ci, gpos - self.starts()[ci]

    def length_of(self, ci: int) -> int:
        return int(self.ends[ci] - self.starts()[ci])

    @classmethod
    def from_fasta(cls, path: str) -> "Genome":
        from .. import native
        if native.available():
            loaded = native.load_seqs(path)
            if loaded is not None:
                names, offsets, codes, _ = loaded
                return cls(names, offsets[1:].copy(), codes)
        names, ends, parts = [], [], []
        off = 0
        for rec in read_fasta(path):
            names.append(rec.name)
            codes = sequtils.encode(rec.seq)
            off += len(codes)
            ends.append(off)
            parts.append(codes)
        return cls(names, np.asarray(ends, dtype=np.int64),
                   np.concatenate(parts) if parts else np.zeros(0, np.uint8))

    @classmethod
    def from_seqs(cls, named_seqs) -> "Genome":
        names, ends, parts = [], [], []
        off = 0
        for name, s in named_seqs:
            names.append(name)
            codes = sequtils.encode(s) if not isinstance(s, np.ndarray) else s
            off += len(codes)
            ends.append(off)
            parts.append(codes)
        return cls(names, np.asarray(ends, dtype=np.int64),
                   np.concatenate(parts) if parts else np.zeros(0, np.uint8))
