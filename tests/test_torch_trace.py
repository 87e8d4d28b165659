"""The span recorder of lra_tpu_torch (utils/timing.RECORDER): off, it
keeps nothing and changes neither the SAM lines nor the Timing report;
on, align_stream at 1 and 3 workers gives one batch span per batch, a
stage span per Timing tick and a span per devstats round with its four
phases, each under a parent of its own batch.  On the CPU the device
rounds run the kernels' plain torch twins (device="cpu")."""

import threading
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

from lra_tpu_torch import preset
from lra_tpu_torch.index.global_index import build_global_index
from lra_tpu_torch.io.genome import Genome
from lra_tpu_torch.pipeline.stream import align_stream
from lra_tpu_torch.sim import random_genome, sample_read
from lra_tpu_torch.utils import devstats
from lra_tpu_torch.utils.timing import RECORDER, Timing

torch.set_num_threads(2)


class AddLog(Timing):
    """Timing that keeps every add, per thread, in order."""

    def __init__(self):
        super().__init__()
        self.adds = defaultdict(list)

    def add(self, label, seconds, cpu_seconds=0.0):
        super().add(label, seconds, cpu_seconds)
        self.adds[threading.get_ident()].append((label, seconds))


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(23)
    g = random_genome(rng, 80000)
    genome = Genome.from_seqs([("chr1", g)])
    opts = preset("ccs")
    idx = build_global_index(genome, opts)
    reads = [(f"r{i}", sample_read(rng, g, 2500, snp=0.003).codes)
             for i in range(6)]
    return genome, idx, opts, [reads[0:2], reads[2:4], reads[4:6]]


@pytest.fixture
def recorder(monkeypatch):
    """The recorder off and devstats off and empty before the test; both
    left so after it."""
    monkeypatch.setattr(devstats, "ENABLED", False)
    RECORDER.stop()
    devstats.reset()
    yield RECORDER
    RECORDER.stop()
    devstats.reset()


def _run(world, workers, timing):
    genome, idx, opts, batches = world
    lines = []
    for _, ls in align_stream(batches, genome, idx, opts, use_device=True,
                              workers=workers, timing=timing, device="cpu"):
        lines.extend(ls)
    return lines


def test_recorder_off_keeps_nothing_and_changes_no_output(world, recorder):
    tm_off = Timing()
    lines_off = _run(world, 1, tm_off)
    assert recorder.spans() == [] and devstats.EVENTS == []
    recorder.start()
    tm_on = Timing()
    lines_on = _run(world, 1, tm_on)
    spans = recorder.stop()
    assert spans
    assert lines_on == lines_off
    assert list(tm_on.totals) == list(tm_off.totals)
    assert tm_on.counts == tm_off.counts


@pytest.mark.parametrize("workers", [1, 3])
def test_spans_of_the_stream(world, recorder, workers):
    genome, idx, opts, batches = world
    recorder.start()
    tm = AddLog()
    _run(world, workers, tm)
    spans = recorder.stop()
    events = list(devstats.EVENTS)
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)

    # every parent exists and belongs to the same batch
    for s in spans:
        if s.kind == "batch":
            assert s.parent is None
        else:
            assert s.parent in by_id, s
            assert by_id[s.parent].batch == s.batch, s
        assert s.batch is not None
        assert s.t1_ns >= s.t0_ns
        assert 0 <= s.cpu_ns <= s.wall_ns + 1_000_000, s

    # one batch span per batch, distinct ids, each with its reads
    bs = [s for s in spans if s.kind == "batch"]
    assert len(bs) == len(batches)
    assert len({s.batch for s in bs}) == len(batches)
    assert sorted(s.counts["reads"] for s in bs) == [2, 2, 2]
    assert sum(s.counts["bases"] for s in bs) == \
        sum(len(r[1]) for b in batches for r in b)

    # stage spans: children of their batch, one per tick, never
    # overlapping on a thread, each the wall of its Timing.add
    stages = defaultdict(list)
    for s in spans:
        if s.kind == "stage":
            assert by_id[s.parent].kind == "batch"
            stages[s.thread].append(s)
    assert set(stages) == set(tm.adds)
    for th, ss in stages.items():
        ss.sort(key=lambda s: s.t0_ns)
        for a, b in zip(ss, ss[1:]):
            assert b.t0_ns >= a.t1_ns
        assert [s.name for s in ss] == [lb for lb, _ in tm.adds[th]]
        for s, (_, sec) in zip(ss, tm.adds[th]):
            assert abs(s.wall_ns / 1e9 - sec) <= 1e-6
    assert sum(len(v) for v in stages.values()) == sum(tm.counts.values())

    # a span per devstats round, inside a stage, with its four phases
    rounds = [s for s in spans if s.kind == "round"]
    assert sorted(s.name for s in rounds) == sorted(t for t, _ in events)
    kids = defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    for r in rounds:
        assert by_id[r.parent].kind in ("stage", "round")
        four = {f"{r.name}.{p}" for p in ("pack", "wait", "copy", "post")}
        phases = [c for c in kids[r.id] if c.kind == "phase"
                  and c.name in four]
        # parts of the round's host work (devstats.Round.part): inside it
        for c in kids[r.id]:
            if c.kind == "phase" and c.name not in four:
                assert c.name in (f"{r.name}.host", "chain_sdp.far"), c
                assert r.t0_ns <= c.t0_ns <= c.t1_ns <= r.t1_ns, c
        assert sorted(c.name for c in phases) == sorted(four)
        assert min(c.t0_ns for c in phases) == r.t0_ns
        assert sum(c.wall_ns for c in phases) == r.wall_ns
        assert {"buckets", "jobs", "launches"} <= set(r.counts)
        pack, = [c for c in phases if c.name.endswith(".pack")]
        assert set(pack.counts) == {"launch_s", "host_s"}


def test_nested_rounds_nest_their_spans(recorder):
    recorder.start()
    outer = devstats.Round()
    inner = devstats.Round()
    inner.launched()
    inner.record("inner", buckets=0, jobs=0)
    outer.launched()
    outer.copied(8)
    outer.record("outer", buckets=1, jobs=1)
    spans = {s.name: s for s in recorder.stop()}
    assert spans["inner"].parent == spans["outer"].id
    assert spans["outer"].parent is None
    for tag in ("inner", "outer"):
        for p in ("pack", "wait", "copy", "post"):
            assert spans[f"{tag}.{p}"].parent == spans[tag].id
    assert spans["inner.copy"].wall_ns == 0     # nothing copied
    assert spans["outer.post"].t1_ns == spans["outer"].t1_ns


@pytest.mark.parametrize("was", [False, True])
def test_stop_restores_devstats(recorder, monkeypatch, was):
    monkeypatch.setattr(devstats, "ENABLED", was)
    recorder.start()
    assert devstats.ENABLED and recorder.on
    recorder.stop()
    assert devstats.ENABLED is was and not recorder.on


def test_timing_reports_thread_cpu_seconds(recorder):
    """A stage that sleeps reads its wall, not its CPU seconds; one that
    computes reads both."""
    tm = Timing()
    tm.start()
    time.sleep(0.05)
    tm.tick("sleep")
    c = time.thread_time()
    while time.thread_time() - c < 0.03:
        pass
    tm.tick("spin")
    assert tm.totals["sleep"] >= 0.05 and tm.cpu["sleep"] < 0.025
    assert tm.totals["spin"] >= tm.cpu["spin"] >= 0.03
    assert recorder.spans() == []


def test_idle_gaps_named_by_the_deepest_open_span():
    """tools/trace_gaps.py: the gaps between device activities, longest
    first, each named per thread by its deepest span across the gap."""
    import importlib.util
    import os
    from types import SimpleNamespace

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "trace_gaps.py")
    spec = importlib.util.spec_from_file_location("trace_gaps", path)
    tg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tg)

    ops = [("k5", 1.0, 2.0), ("copy", 4.0, 4.5), ("k2", 4.25, 5.0)]
    assert tg.idle_gaps(ops, (0.0, 6.0)) == [(2.0, 4.0), (0.0, 1.0),
                                              (5.0, 6.0)]

    def s(id, parent, thread, name, t0, t1, cpu):
        return SimpleNamespace(id=id, parent=parent, thread=thread,
                               name=name, t0_ns=int(t0 * 1e9),
                               t1_ns=int(t1 * 1e9), cpu_ns=int(cpu * 1e9),
                               wall_ns=int((t1 - t0) * 1e9))
    spans = [s(1, None, 7, "batch", 0, 6, 3), s(2, 1, 7, "SDP (device)",
                                                 1, 5, 2),
             s(3, 2, 7, "chain_sdp", 1, 5, 2), s(4, 3, 7, "chain_sdp.pack",
                                                 1, 4, 0.75),
             s(5, None, 9, "batch", 2.5, 6, 1), s(6, 5, 9, "anchors",
                                                  2.5, 6, 1.75)]
    lines = tg.name_gaps([(2.0, 4.0), (5.0, 6.0)], spans, 0.0)
    assert lines[0] == ("2.0000 s @2.000 s: T1 chain_sdp.pack (25 % CPU); "
                        "T2 anchors (50 % CPU)")
    assert lines[1].startswith("1.0000 s @5.000 s: T1 batch (50 % CPU); ")
