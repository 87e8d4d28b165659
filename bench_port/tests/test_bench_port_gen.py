"""The generator: deterministic per seed, and its lengths and errors are
the configuration's."""

import numpy as np
import pytest

from bench_port import registry
from bench_port.gen.genome import make_genome
from bench_port.gen.reads import (length_quantiles, make_reads, mutate_many,
                                  revcomp)
from bench_port.harness import POOL, rng_for

SMALL = {"mb": 0.2, "chromosomes": 2, "seed": 7, "line_copies": 3,
         "line_len": 500, "sat_copies": 20, "sat_len": 171}


def test_genome_is_the_recipe_s():
    names, seqs, reps = make_genome(SMALL)
    again = make_genome(SMALL)[1]
    assert names == ["chr1", "chr2"]
    assert all(len(s) == 100_000 and s.dtype == np.uint8 for s in seqs)
    assert all((a == b).all() for a, b in zip(seqs, again))
    for s, r in zip(seqs, reps):
        assert s.max() <= 3
        unit = s[1000:1500]
        pastes = [(a, b) for a, b in r if b - a == 500]
        assert len(pastes) == 4            # three pastes and the unit
        assert all((s[a:b] == unit).all() for a, b in pastes)
        sat = [(a, b) for a, b in r if b - a == 20 * 171][0]
        arr = s[sat[0]:sat[1]].reshape(20, 171)
        assert (arr == arr[0]).all()


@pytest.mark.parametrize("cfg", ["hifi_chr20", "ont_chr20"])
def test_lengths_follow_the_config(cfg):
    prof = registry.config(cfg)["reads"]
    lens = length_quantiles(prof, 4001)
    assert lens.min() >= prof["min"] and lens.max() <= prof["max"]
    assert abs(np.median(lens) - prof["median"]) <= 1
    # the log-lengths' spread is sigma where the clip does not reach
    q1, q3 = np.quantile(np.log(lens), [0.25, 0.75])
    assert abs((q3 - q1) / 1.349 - prof["sigma"]) < 0.02 * prof["sigma"] + \
        0.01


def test_reads_are_deterministic_per_seed():
    _n, seqs, _r = make_genome(SMALL)
    prof = dict(registry.config("ont_chr20")["reads"], median=2000,
                min=500, max=5000)
    lens = length_quantiles(prof, 40)

    def draw(seed):
        rng = rng_for(seed, POOL)
        return make_reads(rng, seqs, lens[rng.permutation(40)], prof)

    a, b, c = draw(2**31 + 11), draw(2**31 + 11), draw(2**31 + 12)
    assert [r.name for r in a] == [f"r{k}" for k in range(40)]
    assert all((x.codes == y.codes).all() and x.start == y.start
               for x, y in zip(a, b))
    assert any(len(x.codes) != len(y.codes) or (x.codes != y.codes).any()
               for x, y in zip(a, c))
    assert sorted(r.span for r in a) == sorted(r.span for r in c)


def test_read_is_its_source_without_noise():
    _n, seqs, _r = make_genome(SMALL)
    prof = {"snp": 0, "ins": 0, "del": 0, "max_indel": 3, "rev_prob": 0.5}
    rng = np.random.default_rng(3)
    for r in make_reads(rng, seqs, np.full(30, 3000), prof):
        src = seqs[r.chrom][r.start:r.start + r.span]
        assert r.span == 3000 and r.start + r.span <= len(seqs[r.chrom])
        assert (r.codes == (revcomp(src) if r.strand else src)).all()
        assert r.true_as == r.span


@pytest.mark.parametrize("kind", ["snp", "ins", "del"])
def test_true_alignment_score_counts_each_event(kind):
    """span - 2 (deleted + substituted bases) - inserted bases, read off
    each kind of noise alone."""
    rng = np.random.default_rng(11)
    srcs = [rng.integers(0, 4, n, dtype=np.uint8) for n in (900, 4000, 17)]
    rates = {"snp": (0.05, 0, 0), "ins": (0, 0.05, 0), "del": (0, 0, 0.05)}
    out, true_as = mutate_many(rng, [s.copy() for s in srcs], *rates[kind],
                               3)
    for o, s, a in zip(out, srcs, true_as):
        if kind == "snp":
            assert a == len(s) - 2 * int((o != s).sum())
        elif kind == "ins":
            assert a == len(s) - (len(o) - len(s))
        else:
            assert a == len(s) - 2 * (len(s) - len(o))


@pytest.mark.parametrize("cfg", ["hifi_chr20", "ont_chr20"])
def test_error_rates_follow_the_config(cfg):
    prof = registry.config(cfg)["reads"]
    rng = np.random.default_rng(5)
    srcs = [rng.integers(0, 4, 200_000, dtype=np.uint8) for _ in range(5)]
    only = {"snp": (prof["snp"], 0, 0), "ins": (0, prof["ins"], 0),
            "del": (0, 0, prof["del"])}
    # substitutions: the share of bases that differ
    out, _as = mutate_many(rng, [s.copy() for s in srcs], *only["snp"], 3)
    diff = np.mean([np.mean(o != s) for o, s in zip(out, srcs)])
    assert abs(diff - prof["snp"]) < 0.1 * prof["snp"] + 2e-4
    # insertions and deletions: events of 1..3 bases, 2 a event on average
    for kind, sign in (("ins", 1), ("del", -1)):
        out, _as = mutate_many(rng, [s.copy() for s in srcs], *only[kind],
                               3)
        grown = np.mean([len(o) - len(s) for o, s in zip(out, srcs)])
        want = sign * 2 * prof[kind] * 200_000
        assert abs(grown - want) < 0.1 * abs(want) + 30
