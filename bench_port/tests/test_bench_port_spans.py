"""The readers of the program's spans (spans.py and the four metrics that
read them) on synthetic spans, and the None they give where a run holds
no spans."""

from types import SimpleNamespace

import numpy as np
import pytest

from bench_port import harness, registry
from bench_port import spans as sp

S = 1_000_000_000


def span(id, parent, kind, name, t0, t1, cpu, counts=None):
    return SimpleNamespace(id=id, parent=parent, batch=0, thread=1,
                           kind=kind, name=name, t0_ns=int(t0 * S),
                           t1_ns=int(t1 * S), cpu_ns=int(cpu * S),
                           counts=counts,
                           wall_ns=int(t1 * S) - int(t0 * S))


def batch_spans():
    """One batch, 0-10 s: three stages (3, 4 and 1 s; CPU 1, 1 and 0.5)
    and a round in the device stage, waiting 2 s and copying 0.5 s."""
    return [
        span(1, None, "batch", "batch", 0, 10, 1.0, {"reads": 2,
                                                      "bases": 2_000_000}),
        span(2, 1, "stage", "anchors", 1, 4, 1.0),
        span(3, 1, "stage", "gap-align (device)", 4, 8, 1.0),
        span(4, 1, "stage", "score+mapq", 8, 9, 0.5),
        span(5, 3, "round", "gap_align", 4, 8, 0.9),
        span(6, 5, "phase", "gap_align.pack", 4, 5, 0.5),
        span(7, 5, "phase", "gap_align.wait", 5, 7, 0.0),
        span(8, 5, "phase", "gap_align.copy", 7, 7.5, 0.1),
        span(9, 5, "phase", "gap_align.post", 7.5, 8, 0.3),
    ]


def rec(**kw):
    base = dict(window_s=10.0, bases=2_000_000, batches=1,
                latencies_ms=np.arange(1, 11, dtype=float),
                stage_totals={"anchors": 3.0, "gap-align (device)": 4.0,
                              "score+mapq": 1.0},
                devstats={}, busy_s=0.1, hand_device_s={}, hand_bound_s={})
    base.update(kw)
    return harness.Records(**base)


@pytest.mark.parametrize("name, want", [
    ("host.cpu_s_per_mb", (1.0 + 0.5) / 2),
    ("rounds.cpu_s_per_mb", 1.0 / 2),
    # stages off CPU 2 + 3 + 0.5 s, of which waiting on the card
    # 2 (wait) + 0.4 (copy), over 8 s of stage wall
    ("stream.offcpu_pct", 100 * (5.5 - 2.4) / 8),
    # 10 s of batch, 8 s of it inside stages (1-9 s)
    ("stream.self_s_per_mb", 2.0 / 2),
])
def test_span_reader(name, want):
    assert registry.reader(name).read(rec(spans=batch_spans())) == \
        pytest.approx(want)


READERS = ["host.cpu_s_per_mb", "rounds.cpu_s_per_mb", "stream.offcpu_pct",
           "stream.self_s_per_mb"]


@pytest.mark.parametrize("name", READERS)
def test_span_reader_without_spans_gives_none(name, monkeypatch):
    from lra_tpu_torch.utils import timing

    # the program's recorder holds nothing
    monkeypatch.setattr(timing.RECORDER, "spans", lambda: [])
    assert registry.reader(name).read(rec()) is None
    # a program without a recorder (the parent of this benchmark's
    # readers)
    monkeypatch.delattr(timing, "RECORDER")
    assert registry.reader(name).read(rec()) is None
    assert registry.reader(name).read(rec(spans=[])) is None


@pytest.mark.parametrize("name", READERS[:3])
def test_stage_readers_without_stage_spans_give_none(name):
    only_batch = [s for s in batch_spans() if s.kind == "batch"]
    assert registry.reader(name).read(rec(spans=only_batch)) is None


def test_readers_take_the_programs_recorder(monkeypatch):
    from lra_tpu_torch.utils import timing

    monkeypatch.setattr(timing.RECORDER, "spans", batch_spans)
    assert registry.reader("rounds.cpu_s_per_mb").read(rec()) == \
        pytest.approx(0.5)


def test_check_names_labels_off_their_timing_totals(capsys):
    r = rec(spans=batch_spans(),
            stage_totals={"anchors": 3.0, "gap-align (device)": 4.0015,
                          "score+mapq": 1.0, "SDP-1 (device)": 0.5})
    bad = sp.check(r, batch_spans())
    assert [k for k, _a, _b in bad] == ["SDP-1 (device)",
                                       "gap-align (device)"]
    assert sp.check(rec(), batch_spans()) == []
    sp.of(r)
    assert "FAILED" in capsys.readouterr().err


def test_per_name():
    rows = sp.per_name(sp.of_kind(batch_spans(), "phase"))
    assert list(rows) == ["gap_align.pack", "gap_align.wait",
                          "gap_align.copy", "gap_align.post"]
    assert rows["gap_align.wait"] == [2.0, 0.0, 1]
