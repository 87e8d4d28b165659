"""The CONTIG preset's chaining at contig scale, on the CPU (the kernels'
plain twins, device="cpu"):

* the chain driver's windowed path (K7's plain twin, FAR sentinels
  resolved on the host, q-range shards) against the whole chaining SDP
  of bench_port/reference/chain_torch.py, every predecessor counted: V
  equal bit for bit, every row's back pointer and lane attaining it;
* align_stream at 2 workers on draft contigs against align_reads;
* a traced run of it: the chaining round's windowed counts and the
  rounds' ``chain_sdp.far`` and ``indel_refine.host`` parts, each a
  child span of its round.

The blocked buckets are cut to (64,), so that every problem past 64
fragments runs on the windowed kernel.  Where noted, the density
guard's floor (``_windowed_W``'s base) is cut from 4096 to 64 as well,
so that the near window is the guard's own size: the windowed SDP is
then the whole SDP only where the guard's argument holds (no chain edge
spans more than the guard's 50 kb of q outside the window), so the far
case is built to hold it."""

from collections import defaultdict

import numpy as np
import pytest
import torch

from bench_port.reference import chain_torch, sdp
from lra_tpu_torch import preset
from lra_tpu_torch.chain import driver
from lra_tpu_torch.index.global_index import build_global_index
from lra_tpu_torch.io.genome import Genome
from lra_tpu_torch.ops.gapcost import from_options
from lra_tpu_torch.pipeline import align_reads
from lra_tpu_torch.pipeline.stream import align_stream
from lra_tpu_torch.sim import contig_chain_arrays, draft_contig, random_genome
from lra_tpu_torch.utils import devstats
from lra_tpu_torch.utils.timing import RECORDER

torch.set_num_threads(2)

OPTS = preset("contig")


@pytest.fixture
def small_buckets(monkeypatch):
    """Every problem past 64 fragments on the windowed kernel."""
    monkeypatch.setattr(driver, "_BUCKETS", (64,))


def guard_floor_64(mp):
    guard = driver._windowed_W
    mp.setattr(driver, "_windowed_W", lambda qS: guard(qS, base=64))


def far_instance(rng):
    """A problem whose far term wins where the density guard holds: a
    colinear run A of 400 fragments, 1,100 weak decoys over the next 56
    kb of q on diagonals 1-2 Mb away, then a run B 3 Mb off A's diagonal.
    The guard's window (1024) holds no more than the decoys, so B's
    first fragments, and the later decoys, take A's end through the far
    term, whose saturated cost is then exact."""
    nd = 1100
    qA = np.arange(400, dtype=np.int64) * 60
    qD = np.sort(24000 + rng.integers(0, 56000, nd))
    qB = 82000 + np.arange(400, dtype=np.int64) * 60
    qS = np.concatenate([qA, qD, qB])
    tS = np.concatenate([qA + 100,
                         qD + 100 + 10 ** 6 + rng.integers(0, 10 ** 6, nd),
                         qB + 100 + 3 * 10 ** 6])
    score = np.concatenate([np.full(400, 120.0), np.full(nd, 10.0),
                            np.full(400, 120.0)]).astype(np.float32)
    o = np.argsort(qS, kind="stable")
    qS, tS, score = qS[o], tS[o], score[o]
    n = len(qS)
    return (qS, qS + 50, tS, tS + 50, score, np.ones(n, bool),
            np.zeros(n, bool), np.arange(n, dtype=np.int64), 0)


@pytest.mark.parametrize("case", ["windowed", "far", "sharded"])
def test_chain_driver_equals_the_whole_sdp(case, small_buckets, monkeypatch):
    """"windowed": a contig-like problem (sim.contig_chain_arrays) of
    1,500 fragments on K7's plain twin; "far": far_instance under the
    guard's floor cut to 64, whose FAR sentinels the host resolves;
    "sharded": 3,000 contig-like fragments with SHARD_N cut to 1,500, so
    two q-range shard rounds run (each on the windowed kernel), exact but
    for the edges the shards' halo leaves out by design.  The round's
    counts say which path ran."""
    rng = np.random.default_rng({"windowed": 41, "far": 43,
                                 "sharded": 47}[case])
    if case == "far":
        guard_floor_64(monkeypatch)
        arrays = far_instance(rng)
    else:
        arrays = contig_chain_arrays(rng, 1500 if case == "windowed"
                                     else 3000)
    if case == "sharded":
        monkeypatch.setattr(driver, "SHARD_N", 1500)
    p = driver.ChainProblem(*arrays)
    monkeypatch.setattr(devstats, "ENABLED", True)
    devstats.reset()
    driver.solve_problems([p], from_options(OPTS), device="cpu")
    events = [kw for tag, kw in devstats.EVENTS if tag == "chain_sdp"]
    devstats.reset()
    slope, inter = sdp.pwl_params(OPTS.gap_extend, OPTS.gap_root)
    gaps = (slope, inter, float(OPTS.gap_ceiling1),
            float(OPTS.gap_ceiling2))
    ref = chain_torch.solve(p.qS, p.qE, p.tS, p.tE, p.score, p.lane1,
                            p.lane2, gaps, port=(p.V, p.bp, p.lane))
    if case == "sharded":
        # the shards' documented loss: an edge whose predecessor ends more
        # than SHARD_HALO bases of q before its row, outside the row's
        # halo (sim.contig_chain_arrays' saturated t-jumps make a few on
        # the back diagonal); every other row exact
        j = ref["pred"]
        lost = np.flatnonzero((j >= 0) & (p.qS - p.qE[np.maximum(j, 0)]
                                          > driver.SHARD_HALO))
        assert len(lost) <= 3, lost
        exact = np.setdiff1d(np.arange(len(p.qS)), lost)
        np.testing.assert_array_equal(p.V[exact], ref["V"][exact])
        assert set(ref["bad_rows"].tolist()) <= set(lost.tolist())
    else:
        np.testing.assert_array_equal(p.V, ref["V"])
        assert len(ref["bad_rows"]) == 0, ref["bad_rows"][:10]
    assert ref["best"] == float(p.V.max()) > 0
    chain = driver.best_chain(p)
    assert len(chain) >= 2 and p.V[chain[0]] == ref["best"]
    assert all(e["win_jobs"] == 1 and e["win_rows"] > 64
               and e["win_pad_rows"] >= e["win_rows"] for e in events)
    far = sum(e["far_sentinels"] for e in events)
    shards = sum(e["shards"] for e in events)
    if case == "sharded":
        assert len(events) == 2 and shards == 2, events
    else:
        assert len(events) == 1 and shards == 0, events
        assert events[0]["win_rows"] == len(p.qS)
    assert (far > 0) == (case == "far"), events


@pytest.fixture(scope="module")
def contigs():
    """Two 100 kb draft contigs (sim.draft_contig: a 5 kb DEL and a 2 kb
    INS, 0.1 % SNPs, 0.4 % one-base indels) of a 400 kb genome, one a
    batch; the indel-refine round's host cut-off lowered to 256 so that
    its long regions take the host refine DP."""
    rng = np.random.default_rng(31)
    g = random_genome(rng, 400000)
    genome = Genome.from_seqs([("chr1", g)])
    opts = preset("contig")
    opts.refine_dev_max = 256
    idx = build_global_index(genome, opts)
    batches = [[("c1", draft_contig(np.random.default_rng(5), g, 20000,
                                    100000))],
               [("c2", draft_contig(np.random.default_rng(6), g, 200000,
                                    100000))]]
    return genome, idx, opts, batches


@pytest.fixture(scope="module")
def traced_stream(contigs):
    """align_reads on each batch, then align_stream at 2 workers with the
    span recorder on; the buckets cut to (64,) and the guard's floor to
    64 (the windowed kernel's plain twin at 1024 rows a window)."""
    genome, idx, opts, batches = contigs
    mp = pytest.MonkeyPatch()
    mp.setattr(driver, "_BUCKETS", (64,))
    guard_floor_64(mp)
    mp.setattr(devstats, "ENABLED", False)
    RECORDER.stop()
    devstats.reset()
    try:
        seq = [align_reads(b, genome, idx, opts, device="cpu")[1]
               for b in batches]
        RECORDER.start()
        got = [lines for _s, lines in align_stream(
            iter(batches), genome, idx, opts, workers=2, device="cpu")]
        spans = RECORDER.stop()
    finally:
        RECORDER.stop()
        devstats.reset()
        mp.undo()
    return seq, got, spans


def test_contig_stream_matches_align_reads(traced_stream):
    seq, got, _spans = traced_stream
    assert got == seq
    for lines in seq:
        f = lines[0].split("\t")
        assert f[2] == "chr1" and int(f[4]) == 60, f[:6]


def test_traced_contig_stream_records_the_windowed_counts_and_parts(
        traced_stream):
    _seq, _got, spans = traced_stream
    by_id = {s.id: s for s in spans}
    kids = defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    chain = [s for s in spans if s.kind == "round" and s.name == "chain_sdp"]
    assert chain
    for r in chain:
        assert {"win_jobs", "win_rows", "win_pad_rows", "far_sentinels",
                "shards"} <= set(r.counts)
    win = [r for r in chain if r.counts["win_jobs"]]
    assert len(win) >= 2              # SDP-2 of each contig at least
    for r in win:
        far = [c for c in kids[r.id] if c.name == "chain_sdp.far"]
        # the far schedules of each windowed bucket, then the sentinels
        assert len(far) >= 2, kids[r.id]
        for c in far:
            assert c.kind == "phase" and c.batch == r.batch
            assert r.t0_ns <= c.t0_ns <= c.t1_ns <= r.t1_ns
    for r in chain:
        if not r.counts["win_jobs"]:
            assert not [c for c in kids[r.id] if c.name == "chain_sdp.far"]
    refine = [s for s in spans if s.kind == "round"
              and s.name == "indel_refine"]
    assert len(refine) == 2
    host_rows = 0
    for r in refine:
        host, = [c for c in kids[r.id] if c.name == "indel_refine.host"]
        pack, = [c for c in kids[r.id] if c.name == "indel_refine.pack"]
        assert host.kind == "phase" and by_id[host.parent] is r
        assert pack.t0_ns <= host.t0_ns <= host.t1_ns <= pack.t1_ns
        assert host.counts["host_rows"] == r.counts["host_rows"]
        # the span is the round's host_s
        assert abs(host.wall_ns / 1e9 - pack.counts["host_s"]) < 1e-6
        host_rows += r.counts["host_rows"]
    assert host_rows > 0
