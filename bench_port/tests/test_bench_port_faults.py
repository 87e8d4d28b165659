"""The whole run, on the CPU (the kernels' plain twins) at a small size,
with the timed path broken underneath: ``correct`` must come out false
for each fault a cell can have, and true for the sound path.  And the
control, on the card at a cell's own size."""

import io
import json
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from bench_port import registry, run

SEED = 2**31 + 77


def tiny():
    """A small configuration and traffic for the cell ont.t4: its t4 pool,
    with hifi_chr20's reads, which the CPU aligns fastest."""
    cfg = registry.config("hifi_chr20")
    cfg = dict(cfg, name="hifi_tiny", pool_batches=2,
               genome=dict(cfg["genome"], mb=0.4, line_copies=3,
                           line_len=800, sat_copies=20),
               reads=dict(cfg["reads"], median=2500, min=1500, max=4000))
    traffic = dict(registry.traffic("t4"), workers=2, batch_reads=5,
                   warm_batches=1)
    return cfg, traffic


def tiny_run(*extra, trace="0"):
    cfg, traffic = tiny()
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "ont.t4", "--seed", str(SEED),
                       "--seconds", "0.05", "--trace", trace, *extra],
                      device="cpu", cfg=cfg, traffic=traffic, cache=False)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_path_is_correct():
    res = tiny_run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 10 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"bases_per_s", "setup_s"}


def test_traced_run_is_correct_and_reads_its_layers():
    res = tiny_run(trace="1")
    assert res["correct"], res["checks"]
    assert {"stream.overlap", "host.s_per_mb",
            "rounds.s_per_mb"} <= set(res["metrics"])
    assert "breakdown" in res


def _patch_align_reads(monkeypatch, edit):
    import lra_tpu_torch.pipeline as pl

    orig = pl.align_reads

    def broken(reads, *a, **kw):
        states, lines = orig(reads, *a, **kw)
        return states, edit(list(reads), lines)
    monkeypatch.setattr(pl, "align_reads", broken)


def test_half_of_each_batch_left_out(monkeypatch):
    def drop(reads, lines):
        keep = {r[0] for r in reads[:len(reads) // 2]}
        return [ln for ln in lines if ln.split("\t", 1)[0] in keep]
    _patch_align_reads(monkeypatch, drop)
    res = tiny_run()
    assert not res["correct"]
    assert res["checks"]["batches.wrong_reads"]["value"] > 0
    assert res["failed"] > 0


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    def shift(reads, lines):
        out = []
        for ln in lines:
            f = ln.split("\t")
            if f[2] != "*":
                f[3] = str(int(f[3]) + 1)
            out.append("\t".join(f))
        return out
    _patch_align_reads(monkeypatch, shift)
    res = tiny_run()
    assert not res["correct"]
    assert res["checks"]["sam.inconsistent"]["value"] > 0


def test_a_traceback_altered_in_the_banded_kernel(monkeypatch):
    import lra_tpu_torch.pipeline.gap_align as ga

    for name in ("banded_global_traced_packed", "banded_refine_traced_packed"):
        orig = getattr(ga, name)

        def broken(*a, _orig=orig, **kw):
            out = _orig(*a, **kw).clone()
            first = out[:, 0]
            # the first op of each problem turned into the next op code
            out[:, 0] = (first & 0xFC) | next_op(first & 3)
            return out
        monkeypatch.setattr(ga, name, broken)
    res = tiny_run()
    assert not res["correct"]
    assert res["checks"]["k4.not_optimal"]["value"] + \
        res["checks"]["k5.not_optimal"]["value"] > 0


def next_op(op):
    """LEFT -> DOWN -> DIAG -> LEFT; the end code stays."""
    return (op % 3 + 1) * (op > 0)


@pytest.mark.parametrize("fault", ["score", "path"])
def test_an_answer_altered_in_the_one_gap_kernel(monkeypatch, fault):
    """The score one off, or the path's last DIAG made a gap pair: a path
    still valid, which scores less than the optimum."""
    import torch

    import lra_tpu_torch.pipeline.gap_align as ga

    orig = ga.one_gap_traced

    def broken(*a, **kw):
        ops, jump, score = orig(*a, **kw)
        if fault == "score":
            return ops, jump, score + 1
        ops = ops.clone()
        first = ops[:, 0]
        ops[:, 1:] = ops[:, :-1].clone()
        ops[:, 0] = torch.where(first == 3, 1, first)       # DIAG -> LEFT
        ops[:, 1] = torch.where(first == 3, 2, ops[:, 1])   # and DOWN
        return ops, jump, score
    monkeypatch.setattr(ga, "one_gap_traced", broken)
    res = tiny_run()
    assert not res["correct"]
    assert res["checks"]["k6.not_optimal"]["value"] > 0


@pytest.mark.parametrize("fault,number", [
    ("truncate", "sam.unaligned_pct"), ("truncate", "sam.ends_off"),
    ("truncate", "sam.as_short_pct"), ("mapq_zero", "sam.mapq0")])
def test_a_record_cut_short_or_unplaced_where_it_is_produced(
        monkeypatch, fault, number):
    """Each record's alignment cut to half the read, consistent and placed;
    or its MAPQ 0: the numbers held to the read's truth see it."""
    from bench_port import faults

    def edit(reads, lines):
        return [faults.FAULTS[fault](ln) for ln in lines]
    _patch_align_reads(monkeypatch, edit)
    res = tiny_run()
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"]
    assert res["checks"]["sam.inconsistent"]["value"] == 0
    assert res["checks"]["sam.misplaced"]["value"] == 0


def test_a_chain_score_altered_in_the_sdp_kernel(monkeypatch):
    import lra_tpu_torch.chain.driver as drv

    orig = drv.chain_scores_blocked

    def broken(*a, **kw):
        V, bp, lane = orig(*a, **kw)
        return V + a[7].float(), bp, lane
    monkeypatch.setattr(drv, "chain_scores_blocked", broken)
    res = tiny_run()
    assert not res["correct"]
    assert res["checks"]["k2.wrong_rows"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ont.t4", "ont.t1"])
def test_control_in_bfloat16_is_not_correct_on_the_card(cell):
    """The reference in bfloat16 put in the kernels' place, at the cell's
    own size, three seeds: each must come out not correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        p = subprocess.run(
            [sys.executable, "bench_port/run.py", "--workload", cell,
             "--seed", str(seed), "--seconds", "5", "--trace", "0",
             "--control", "bf16"], cwd=registry.ROOT, capture_output=True,
            text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        res = json.loads(p.stdout.strip().splitlines()[-1])
        assert not res["correct"], res["checks"]


def test_readings_part_the_sound_output_from_the_faults():
    """readings.py on two seeds: every sound reading within its limit,
    and each planted fault past the limit of a number."""
    from bench_port import check, readings

    cfg, traffic = tiny()
    out = io.StringIO()
    with redirect_stdout(out):
        rc = readings.main(["--workload", "ont.t4", "--seeds",
                            f"{SEED},{SEED + 1}", "--seconds", "0.05",
                            "--controls", "1"], device="cpu", cfg=cfg,
                           traffic=traffic, cache=False)
    assert rc == 0
    rows = [json.loads(x) for x in out.getvalue().strip().splitlines()]
    assert len(rows) == 3 and "bf16" in rows[0] and "bf16" not in rows[1]
    summary = rows[-1]
    assert all(v <= check.LIMITS[k] for k, v in summary["sound_max"].items())
    for label in ("bf16_min", "truncate_min", "mapq_zero_min"):
        assert any(v > check.LIMITS[k] for k, v in summary[label].items()), \
            label


def test_control_in_bfloat16_is_not_correct_here():
    res = tiny_run("--control", "bf16")
    assert not res["correct"], res["checks"]
    bad = sum(res["checks"][k]["value"] for k in
              ("k2.wrong_rows", "k4.not_optimal", "k5.not_optimal"))
    assert bad > 0

