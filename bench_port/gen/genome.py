"""The reference genome of a configuration, from its recipe.

Frozen copy, rewritten in numpy, of two recipes of the repository:
``random_genome`` (lra_tpu_torch/sim.py:19-20: uniform 2-bit codes) and
bench.py's ``bench_genome`` (bench.py:139-166): each chromosome is
uniform random sequence salted with ``line_copies`` pastes of one
``line_len``-base unit (a LINE-like repeat) and a tandem array of
``sat_copies`` copies of one ``sat_len``-base unit (a satellite).  Codes
are drawn as uint8 directly, so the sequence differs from bench.py's
draw for draw; the recipe and its statistics are the same.

The genome is part of the deployment, not of a run: it is drawn from the
recipe's own ``seed``, so every run of a configuration aligns to the same
genome and its index can be cached.
"""

from __future__ import annotations

import numpy as np


def make_genome(spec: dict):
    """(names, [uint8 codes per chromosome], repeats) from a genome recipe
    (keys mb, chromosomes, seed, line_copies, line_len, sat_copies,
    sat_len).  repeats: per chromosome, a sorted int64 [n, 2] array of
    the [start, end) intervals the salting wrote."""
    rng = np.random.default_rng(int(spec["seed"]))
    n_chrom = int(spec["chromosomes"])
    per = int(float(spec["mb"]) * 1_000_000) // n_chrom
    line_len, sat_len = int(spec["line_len"]), int(spec["sat_len"])
    sat_copies = int(spec["sat_copies"])
    names, seqs, repeats = [], [], []
    for c in range(n_chrom):
        g = rng.integers(0, 4, size=per, dtype=np.uint8)
        unit = g[1000:1000 + line_len].copy()
        spans = []
        for _ in range(int(spec["line_copies"])):
            p = int(rng.integers(0, per - line_len - 1000))
            g[p:p + line_len] = unit
            spans.append((p, p + line_len))
        spans.append((1000, 1000 + line_len))
        sat = g[100:100 + sat_len].copy()
        p0 = int(rng.integers(0, per - 2 * sat_len * sat_copies))
        for k in range(sat_copies):
            g[p0 + k * sat_len:p0 + (k + 1) * sat_len] = sat
        spans.append((p0, p0 + sat_copies * sat_len))
        spans.append((100, 100 + sat_len))
        names.append(f"chr{c + 1}")
        seqs.append(g)
        repeats.append(np.array(sorted(spans), dtype=np.int64))
    return names, seqs, repeats
