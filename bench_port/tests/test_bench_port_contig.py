"""The contig.draft cell's pieces: its configuration and traffic found by
name, the three readers it adds (on synthetic records, and the None they
give where a run holds nothing to read), and a whole traced run on the
CPU (the kernels' plain twins) on a cut copy of contig_chr20 that ends
correct, with its windowed chaining read by the output check."""

import io
import json
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest

from bench_port import harness, registry, run

BENCH = registry.benchmark()
S = 1_000_000_000
NEW = ("k7.roofline", "chain.far_s_per_mb", "refine.host_s_per_mb")


def span(id, parent, kind, name, t0, t1, counts=None):
    return SimpleNamespace(id=id, parent=parent, batch=0, thread=1,
                           kind=kind, name=name, t0_ns=int(t0 * S),
                           t1_ns=int(t1 * S), cpu_ns=0, counts=counts,
                           wall_ns=int(t1 * S) - int(t0 * S))


def spans():
    """One batch: a chaining round with two chain_sdp.far parts (0.5 and
    0.25 s) and two indel-refine rounds with a host part each (1 and
    2 s)."""
    return [
        span(1, None, "batch", "batch", 0, 20, {"reads": 2,
                                                "bases": 4_000_000}),
        span(2, 1, "stage", "SDP-2 (device)", 0, 5),
        span(3, 2, "round", "chain_sdp", 0, 5, {"win_jobs": 2}),
        span(4, 3, "phase", "chain_sdp.far", 0.5, 1.0),
        span(5, 3, "phase", "chain_sdp.far", 4.0, 4.25),
        span(6, 1, "stage", "indel-refine (device)", 5, 15),
        span(7, 6, "round", "indel_refine", 5, 10, {"host_rows": 3}),
        span(8, 7, "phase", "indel_refine.host", 6, 7, {"host_rows": 3}),
        span(9, 6, "round", "indel_refine", 10, 15, {"host_rows": 1}),
        span(10, 9, "phase", "indel_refine.host", 11, 13, {"host_rows": 1}),
        span(11, 9, "phase", "gap_align.host", 11, 13, {"host_rows": 1}),
    ]


def rec(**kw):
    base = dict(window_s=20.0, bases=4_000_000, batches=1,
                latencies_ms=np.arange(1, 3, dtype=float),
                stage_totals={"SDP-2 (device)": 5.0,
                              "indel-refine (device)": 10.0},
                devstats={}, busy_s=0.2,
                hand_device_s={"k2_sdp": 0.02, "k7_windowed": 0.05},
                hand_bound_s={"k2_sdp": 0.001, "k7_windowed": 0.0005},
                spans=spans())
    base.update(kw)
    return harness.Records(**base)


@pytest.mark.parametrize("name, want", [
    ("k7.roofline", 100 * 0.0005 / 0.05),
    ("chain.far_s_per_mb", 0.75 / 4.0),
    ("refine.host_s_per_mb", 3.0 / 4.0),
])
def test_reader(name, want):
    assert registry.reader(name).read(rec()) == pytest.approx(want)


@pytest.mark.parametrize("name, empty", [
    ("k7.roofline", dict(hand_device_s={"k2_sdp": 0.02},
                         hand_bound_s={"k2_sdp": 0.001})),
    ("k7.roofline", dict(hand_device_s={}, hand_bound_s={})),
    ("chain.far_s_per_mb", dict(spans=[])),
    ("chain.far_s_per_mb", dict(spans=[s for s in spans()
                                       if s.name != "chain_sdp.far"])),
    ("refine.host_s_per_mb", dict(spans=[])),
    ("refine.host_s_per_mb", dict(spans=[s for s in spans()
                                         if s.name != "indel_refine.host"])),
])
def test_nothing_to_read_gives_none(name, empty):
    assert registry.reader(name).read(rec(**empty)) is None


def _problem(rng, n, lane1):
    qS = np.sort(rng.integers(0, 60 * n, n)).astype(np.int64)
    ln = rng.integers(15, 60, n)
    tS = (qS + rng.integers(-3000, 3000, n)).clip(0)
    l1 = rng.random(n) < lane1
    return (qS, qS + ln, tS, tS + ln, (2.0 * ln).astype(np.float32), l1,
            ~l1)


def test_whole_sdp_reference_is_reference_sdp_row_by_row():
    """chain_torch against reference/sdp.py's Chain on problems with both
    lanes, one lane and one row: the same V bit for bit and the same rows
    judged bad, for a sound answer and for one with a back pointer, a
    lane and a score altered; several problems at once give each
    problem's own answer."""
    from bench_port.reference import chain_torch, sdp

    rng = np.random.default_rng(18)
    slope, inter = sdp.pwl_params(20.0, 1.5)
    gaps = (slope, inter, 3000.0, 5000.0)
    probs = [_problem(rng, n, f) for n, f in ((300, 0.7), (180, 1.0),
                                               (1, 0.0), (240, 0.0))]
    many = chain_torch.solve_many(probs, gaps)
    for pr, got in zip(probs, many):
        ch = sdp.Chain(*pr, gaps)
        V = ch.scores()
        np.testing.assert_array_equal(got["V"], V)
        one = chain_torch.solve(*pr, gaps)
        np.testing.assert_array_equal(one["V"], V)
        assert one["chain"] == got["chain"]
        assert got["best"] == float(V.max())
        if len(V) > 1:
            assert len(got["chain"]) > 1
        ch_v = [int(V[k]) for k in got["chain"]]
        assert ch_v == sorted(ch_v, reverse=True)
        bp = got["pred"].astype(np.int32)
        lane = np.where(bp < 0, 0, np.where(pr[5], 1, 2)).astype(np.int32)
        sound = chain_torch.solve(*pr, gaps, port=(V, bp, lane))
        assert len(sound["bad_rows"]) == ch.bad_rows(V, bp, lane) == 0
        if len(V) < 100:
            continue
        V2, bp2, lane2 = V.copy(), bp.copy(), lane.copy()
        k = np.flatnonzero(bp >= 1)[:3]
        bp2[k[0]] = 0
        lane2[k[1]] = 3 - lane2[k[1]]
        V2[k[2]] += 1
        bad = chain_torch.solve(*pr, gaps, port=(V2, bp2, lane2))
        assert len(bad["bad_rows"]) == ch.bad_rows(V2, bp2, lane2) >= 2


def test_contig_cell_resolves_to_its_files():
    cell = registry.cell("contig.draft", BENCH)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("contig_chr20", "t4c2", 1)
    cfg = registry.config("contig_chr20")
    ont = registry.config("ont_chr20")
    assert cfg["preset"] == "contig" and cfg["genome"] == ont["genome"]
    assert cfg["reduced"] == ont["reduced"]
    r = cfg["reads"]
    assert r["median"] == r["min"] == r["max"] == 2_500_000
    assert r["sigma"] == 0 and r["max_indel"] == 1
    traffic = registry.traffic("t4c2")
    assert (traffic["loop"], traffic["workers"], traffic["batch_reads"],
            traffic["warm_batches"]) == ("closed", 4, 2, 5)
    layer = {m["name"] for m in registry.metrics_for("contig.draft", BENCH,
                                                     "per_layer")}
    assert set(NEW) <= layer and "device.idle" in layer
    assert "host.cpu_s_per_mb" not in layer
    for cell in ("ont.t4", "ont.t1"):
        layer = {m["name"] for m in registry.metrics_for(cell, BENCH,
                                                         "per_layer")}
        assert "refine.host_s_per_mb" in layer
        assert not {"k7.roofline", "chain.far_s_per_mb"} & layer


def tiny():
    """contig_chr20 cut to a 1.5 Mb genome and 30 kb contigs, two a
    batch, one worker."""
    cfg = registry.config("contig_chr20")
    cfg = dict(cfg, name="contig_tiny", pool_batches=1,
               genome=dict(cfg["genome"], mb=1.5, line_copies=3,
                           line_len=800, sat_copies=20),
               reads=dict(cfg["reads"], median=30000, min=30000,
                          max=30000))
    traffic = dict(registry.traffic("t4c2"), workers=1, warm_batches=1)
    return cfg, traffic


def test_traced_run_of_a_cut_contig_cell_is_correct(monkeypatch):
    """Every chaining problem past 64 fragments on the windowed kernel
    (the blocked buckets cut to (64,), the density guard's floor to 64),
    so the window's K7 calls are read by the output check and by
    chain.far_s_per_mb.  The program is loaded already, so the recorder
    and devstats are switched on here, as LRA_TPU_DEVSTATS does at its
    import in the benchmark's traced runs."""
    from lra_tpu_torch.chain import driver
    from lra_tpu_torch.utils import devstats
    from lra_tpu_torch.utils.timing import RECORDER

    monkeypatch.setattr(RECORDER, "on", True)
    monkeypatch.setattr(devstats, "ENABLED", True)
    monkeypatch.setenv("LRA_TPU_DEVSTATS", "1")   # run.main sets it too
    guard = driver._windowed_W
    monkeypatch.setattr(driver, "_BUCKETS", (64,))
    monkeypatch.setattr(driver, "_windowed_W",
                        lambda qS: guard(qS, base=64))
    cfg, traffic = tiny()
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "contig.draft", "--seed",
                       str(2 ** 31 + 18), "--seconds", "0.05", "--trace",
                       "1"], device="cpu", cfg=cfg, traffic=traffic,
                      cache=False)
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert res["checks"]["k7.wrong_rows"]["value"] == 0
    m = res["metrics"]
    assert m["chain.far_s_per_mb"]["value"] > 0
    assert m["refine.host_s_per_mb"]["value"] >= 0
    assert "k7.roofline" not in m            # no device trace here
    devstats.reset()
