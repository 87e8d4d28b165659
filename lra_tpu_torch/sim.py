"""Read simulation for tests and benchmarks.

A lightweight stand-in for the reference's ``alchemy2`` model-based
simulator (reference: Alchemy2.cpp:32-63): random genomes, and reads
sampled from them with configurable SNP/indel/SV error processes and
strand.  Error positions are uniform rather than k-mer-context-conditioned;
the full empirical-model simulator is a later milestone.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import seq as sequtils


def random_genome(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 4, size=n, dtype=np.int64).astype(np.uint8)


@dataclass
class SimRead:
    codes: np.ndarray      # read 2-bit codes (as sequenced)
    chrom_pos: int         # true genome start of the aligned span
    genome_span: int       # true genome bases covered
    strand: int            # 0 fwd, 1 rev
    cigar_ops: list = field(default_factory=list)   # ground-truth edit list


def mutate(rng, codes: np.ndarray, snp=0.0, ins=0.0, dele=0.0,
           max_indel: int = 3) -> np.ndarray:
    """Apply uniform SNP/indel noise to a code array."""
    out = []
    i = 0
    n = len(codes)
    while i < n:
        r = rng.random()
        if r < dele:
            i += int(rng.integers(1, max_indel + 1))
            continue
        if r < dele + ins:
            ln = int(rng.integers(1, max_indel + 1))
            out.append(rng.integers(0, 4, size=ln, dtype=np.int64).astype(np.uint8))
        c = codes[i]
        if rng.random() < snp:
            c = np.uint8((int(c) + int(rng.integers(1, 4))) % 4)
        out.append(np.array([c], dtype=np.uint8))
        i += 1
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


def sample_read(rng, genome_codes: np.ndarray, length: int,
                snp=0.0, ins=0.0, dele=0.0, rev_prob=0.5) -> SimRead:
    start = int(rng.integers(0, max(1, len(genome_codes) - length)))
    span = genome_codes[start:start + length]
    read = mutate(rng, span, snp=snp, ins=ins, dele=dele)
    strand = int(rng.random() < rev_prob)
    if strand:
        read = sequtils.revcomp(read)
    return SimRead(read, start, len(span), strand)
