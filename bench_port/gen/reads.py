"""Simulated reads of a run, drawn from ``--seed``.

Frozen copy, rewritten in numpy and vectorised over a batch of reads, of
``mutate`` and ``sample_read`` (lra_tpu_torch/sim.py:33-63): a read is a
span of one chromosome, start uniform, on either strand, with uniform
per-base noise.  At each source base an event is drawn: a deletion (rate
``del``) removes 1..max_indel bases from there on; an insertion (rate
``ins``) puts 1..max_indel random bases before the base; a surviving base
is substituted (rate ``snp``) by one of the three other bases.  Each base
has one event at most, and unlike sim.py a read never crosses a
chromosome's end.  Each read keeps the score of its true alignment to
its source under lra's run scoring (a base +1 matched, -1 substituted,
-1 inserted or deleted, which is the score of every gap run of at most
20 bases, as nearly all are with events of 1-3 bases):
span - 2 (deleted + substituted) - inserted.

Read lengths follow the configuration's clipped lognormal: a batch of n
reads takes the distribution's quantiles at (k + 0.5) / n (harness.py
orders them by the seed), so every seed aligns the same lengths in every
batch: the seed changes which reads, not how much work.
"""

from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass
class Read:
    name: str
    codes: np.ndarray     # uint8 2-bit codes as sequenced
    chrom: int            # source chromosome
    start: int            # source span [start, start + span)
    span: int
    strand: int           # 0 forward, 1 reverse complement
    true_as: int = 0      # the score of the true alignment (see above)


def length_quantiles(profile: dict, n: int) -> np.ndarray:
    """n read lengths: the clipped lognormal's quantiles at (k+0.5)/n."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((k + 0.5) / n) for k in range(n)])
    lens = float(profile["median"]) * np.exp(float(profile["sigma"]) * z)
    return np.clip(np.rint(lens), profile["min"], profile["max"]).astype(
        np.int64)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The concatenated ranges [s, s + n) of each start s and length n."""
    off = np.repeat(np.cumsum(lens) - lens, lens)
    return np.repeat(starts, lens) + np.arange(int(lens.sum())) - off


def mutate_many(rng, srcs: list, snp: float, ins: float, dele: float,
                max_indel: int) -> tuple:
    """Apply the noise model to each source span of ``srcs`` at once: one
    uniform draw a base picks its event (deletion, insertion, SNP or
    none); lengths and new bases are drawn for the events alone.
    Returns (reads, each read's true alignment score)."""
    lens = np.array([len(s) for s in srcs], dtype=np.int64)
    ends = np.cumsum(lens)
    base = np.concatenate(srcs)
    r = rng.random(len(base), dtype=np.float32)
    d0 = np.flatnonzero(r < dele)
    i0 = np.flatnonzero((r >= dele) & (r < dele + ins))
    s0 = np.flatnonzero((r >= dele + ins) & (r < dele + ins + snp))
    base[s0] = (base[s0] + rng.integers(1, 4, size=len(s0),
                                        dtype=np.uint8)) & 3
    read_end = ends[np.searchsorted(ends, d0, side="right")]
    dl = np.minimum(rng.integers(1, max_indel + 1, size=len(d0)),
                    read_end - d0)
    gone = np.unique(_ranges(d0, dl))
    i0 = i0[~np.isin(i0, gone)]
    il = rng.integers(1, max_indel + 1, size=len(i0))
    keep = np.ones(len(base), dtype=bool)
    keep[gone] = False
    at = np.repeat(i0 - np.searchsorted(gone, i0), il)
    out = np.insert(base[keep], at, rng.integers(0, 4, size=len(at),
                                                  dtype=np.uint8))
    cut = ends - np.searchsorted(gone, ends) + \
        np.concatenate(([0], np.cumsum(il)))[np.searchsorted(i0, ends)]
    bounds = np.concatenate(([0], cut))

    def per_read(pos, weights=None):
        return np.bincount(np.searchsorted(ends, pos, side="right"),
                           weights=weights, minlength=len(srcs))
    true_as = lens - 2 * per_read(gone) - 2 * per_read(
        s0[~np.isin(s0, gone)]) - per_read(i0, il)
    return ([out[bounds[k]:bounds[k + 1]] for k in range(len(srcs))],
            true_as.astype(np.int64))


def make_reads(rng, seqs: list, lengths: np.ndarray, profile: dict,
               prefix: str = "r", chunk: int = 64) -> list:
    """Reads of the given lengths (in that order) from the chromosomes
    ``seqs``, named prefix0, prefix1, ...  Draws from ``rng`` only."""
    sizes = np.array([len(s) for s in seqs], dtype=np.float64)
    p = sizes / sizes.sum()
    snp, ins, dele = (float(profile[k]) for k in ("snp", "ins", "del"))
    max_indel = int(profile["max_indel"])
    rev = float(profile["rev_prob"])
    out = []
    for c0 in range(0, len(lengths), chunk):
        part = lengths[c0:c0 + chunk]
        chroms = rng.choice(len(seqs), size=len(part), p=p)
        spans = [min(int(ln), len(seqs[c]) - 1) for ln, c in
                 zip(part, chroms)]
        starts = [int(rng.integers(0, len(seqs[c]) - sp))
                  for c, sp in zip(chroms, spans)]
        strands = rng.random(len(part)) < rev
        srcs = [seqs[c][s:s + sp] for c, s, sp in zip(chroms, starts, spans)]
        reads, true_as = mutate_many(rng, srcs, snp, ins, dele, max_indel)
        for k, codes in enumerate(reads):
            strand = int(strands[k])
            out.append(Read(f"{prefix}{c0 + k}",
                            revcomp(codes) if strand else codes,
                            int(chroms[k]), starts[k], spans[k], strand,
                            int(true_as[k])))
    return out
