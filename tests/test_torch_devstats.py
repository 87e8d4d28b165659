"""Device-round statistics of lra_tpu_torch (utils/devstats.py): off, the
hooks add no event and make no torch.cuda call; on, one CCS batch
records the rounds, buckets and jobs per round tag that lra_tpu's
devstats records on the same batch (lra_tpu on JAX's CPU backend, the
port on device="cpu").  Tolerance: exact counts."""

import io

import numpy as np
import pytest
import torch

from lra_tpu_torch import preset as t_preset
from lra_tpu_torch.index.global_index import \
    build_global_index as t_build_global_index
from lra_tpu_torch.io.genome import Genome as TGenome
from lra_tpu_torch.pipeline import align_reads as t_align_reads
from lra_tpu_torch.sim import random_genome, sample_read
from lra_tpu_torch.utils import devstats

torch.set_num_threads(2)

COUNTS = ("rounds", "buckets", "jobs", "small_jobs")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(19)
    g = random_genome(rng, 60000)
    reads = [(f"r{i}", sample_read(rng, g, 2500, snp=0.003).codes)
             for i in range(4)]
    return [("chr1", g)], reads


def _cuda_refuses(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("torch.cuda called with devstats off")

    for name in ("Event", "Stream", "synchronize", "current_stream",
                 "stream", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)


def test_devstats_off_adds_nothing(world, monkeypatch):
    seqs, reads = world
    genome = TGenome.from_seqs(seqs)
    opts = t_preset("ccs")
    idx = t_build_global_index(genome, opts)
    monkeypatch.setattr(devstats, "ENABLED", False)
    devstats.reset()
    _cuda_refuses(monkeypatch)
    _, lines = t_align_reads(reads, genome, idx, opts, device="cpu")
    assert len(lines) >= len(reads)
    assert devstats.EVENTS == []


def test_devstats_off_launch_makes_no_event(monkeypatch):
    """ops/_ext.launch with devstats off: the C entry point gets the
    stream handle, and no CUDA event is made."""
    from lra_tpu_torch.ops import _ext

    class Stream:
        cuda_stream = 7

    seen = []
    monkeypatch.setattr(devstats, "ENABLED", False)
    monkeypatch.setattr(_ext, "_entry", lambda lib, fn, argtypes:
                        (lambda *args: seen.append(args) or 0))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream)
    monkeypatch.setattr(torch.cuda, "Event", None)
    _ext.launch("one_gap_traced", "one_gap", "f", [], 1, 2)
    _ext.reset_launches()
    assert seen == [(1, 2, 7)]


def test_devstats_rounds_equal_jax(world, monkeypatch):
    """Per tag (chain_sdp, refine_boxes, gap_align, indel_refine): the
    port's rounds, buckets, jobs and small jobs equal lra_tpu's on one
    4-read CCS batch, every round with its timings."""
    from lra_tpu import preset
    from lra_tpu.index.global_index import build_global_index
    from lra_tpu.io.genome import Genome
    from lra_tpu.pipeline import align_reads
    from lra_tpu.utils import devstats as jdevstats

    seqs, reads = world
    monkeypatch.setattr(jdevstats, "ENABLED", True)
    monkeypatch.setattr(devstats, "ENABLED", True)
    jdevstats.reset()
    devstats.reset()
    g = Genome.from_seqs(seqs)
    align_reads(reads, g, build_global_index(g, preset("ccs")),
                preset("ccs"), use_device=True)
    tg = TGenome.from_seqs(seqs)
    t_align_reads(reads, tg, t_build_global_index(tg, t_preset("ccs")),
                  t_preset("ccs"), device="cpu")
    want, got = jdevstats.report(), devstats.report()
    jdevstats.reset()
    devstats.reset()
    assert set(want) == {"chain_sdp", "refine_boxes", "gap_align",
                         "indel_refine"}
    assert set(got) == set(want)
    for tag in want:
        assert {c: got[tag].get(c) for c in COUNTS} == \
            {c: want[tag].get(c) for c in COUNTS}, tag
        for c in ("pack_s", "compute_s", "copy_s", "post_s"):
            assert got[tag][c] >= 0.0, (tag, c)
        assert got[tag]["launches"] == 0        # plain twins: no launch
    assert got["gap_align"]["bytes"] > 0


def test_devstats_round_without_device_buckets(monkeypatch):
    """A round whose jobs all ran on the host launches and copies
    nothing: its pack time still covers its host jobs."""
    import time

    monkeypatch.setattr(devstats, "ENABLED", True)
    devstats.reset()
    rnd = devstats.Round()
    t0 = devstats.now()
    time.sleep(0.01)
    rnd.host_s = devstats.now() - t0
    rnd.launched()
    rnd.record("indel_refine", buckets=0, jobs=0, small_jobs=0)
    (tag, kw), = devstats.EVENTS
    devstats.reset()
    assert tag == "indel_refine"
    assert kw["pack_s"] >= kw["host_s"] >= 0.01
    assert kw["launches"] == 0 and kw["bytes"] == 0
    assert kw["copy_s"] == 0.0
    assert kw["post_s"] < kw["host_s"]


def test_devstats_report_table(monkeypatch):
    """report() prints lra_tpu's table: one row per tag, its columns."""
    monkeypatch.setattr(devstats, "ENABLED", True)
    devstats.reset()
    devstats.record("gap_align", buckets=2, jobs=5, small_jobs=1,
                    pack_s=0.5, compute_s=0.25, copy_s=0.0, post_s=0.125,
                    bytes=64)
    devstats.record("gap_align", buckets=1, jobs=3, small_jobs=0,
                    pack_s=0.5, compute_s=0.25, copy_s=0.0, post_s=0.125,
                    bytes=32)
    buf = io.StringIO()
    agg = devstats.report(buf)
    devstats.reset()
    assert agg["gap_align"]["rounds"] == 2
    assert agg["gap_align"]["jobs"] == 8
    rows = [ln.split("\t") for ln in buf.getvalue().splitlines()]
    assert rows[0] == ["round", "rounds", "buckets", "jobs", "small_jobs",
                       "pack_s", "compute_s", "copy_s", "post_s", "bytes"]
    assert rows[1] == ["gap_align", "2", "3", "8", "1", "1.0000", "0.5000",
                       "0.0000", "0.2500", "96"]


def test_devstats_gap_table_rows(monkeypatch):
    """On a small ONT batch: the gap-align round's rows taken from the
    batch's gap table and decoded as arrays (``table_rows``) and the
    others (``object_rows``) add up to its ``jobs``; ``object_rows``
    holds every row decoded one at a time (K6's) and ``host_rows``
    counts the host fallbacks, which are in no bucket."""
    from lra_tpu_torch.index.local_index import build_genome_local_index
    from lra_tpu_torch.pipeline import gap_align, highacc

    rng = np.random.default_rng(9)
    genome = TGenome.from_seqs([("chr1", random_genome(rng, 150000))])
    opts = t_preset("ont")
    idx = t_build_global_index(genome, opts)
    gli = build_genome_local_index(genome, max_freq=opts.local_max_freq)
    reads = [(f"ont{i}", sample_read(rng, genome.codes, 6000, snp=0.03,
                                     ins=0.01, dele=0.01,
                                     rev_prob=0.5).codes)
             for i in range(2)]
    seen = {"one_gap": 0, "host": 0}
    table_round = []

    def solve(jobs, *a, **k):
        table_round.append(isinstance(jobs, gap_align.GapTable))
        try:
            return solve_orig(jobs, *a, **k)
        finally:
            table_round.pop()

    def counting(name, f):
        def g(*a, **k):
            if table_round and table_round[-1]:
                seen[name] += 1
            return f(*a, **k)
        return g

    solve_orig = highacc.solve_gap_jobs
    monkeypatch.setattr(highacc, "solve_gap_jobs", solve)
    monkeypatch.setattr(gap_align, "blocks_from_one_gap_ops", counting(
        "one_gap", gap_align.blocks_from_one_gap_ops))
    monkeypatch.setattr(gap_align, "affine_one_gap_align", counting(
        "host", gap_align.affine_one_gap_align))
    monkeypatch.setattr(devstats, "ENABLED", True)
    devstats.reset()
    _, lines = t_align_reads(reads, genome, idx, opts, genome_li=gli,
                             device="cpu")
    rounds = [kw for tag, kw in devstats.EVENTS if tag == "gap_align"]
    devstats.reset()
    assert len(lines) >= len(reads)
    assert len(rounds) == 1
    kw = rounds[0]
    assert kw["table_rows"] + kw["object_rows"] == kw["jobs"] > 0
    assert kw["object_rows"] >= seen["one_gap"]
    assert kw["host_rows"] == seen["host"]
    assert kw["table_rows"] > kw["object_rows"]
