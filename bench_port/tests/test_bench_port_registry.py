"""Configurations, traffic mixes, metric readers and rooflines are found
by name, so that adding one is adding files."""

import json
import os
import shutil

import pytest

from bench_port import registry

BENCH = registry.benchmark()


def test_every_name_in_benchmark_resolves_to_files():
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(registry.ROOT, c["file"]))
        assert registry.config(c["name"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert registry.traffic(w["traffic"])["workers"] >= 1
        assert registry.cell(w["name"], BENCH)["config"] == w["config"]
    for m in BENCH["per_layer"]:
        assert callable(registry.reader(m["name"]).read)


def test_metrics_for_follows_the_workloads_key():
    for cell in ("ont.t1", "ont.t4"):
        names = {m["name"] for m in registry.metrics_for(cell, BENCH,
                                                         "end_to_end")}
        assert names == {"bases_per_s", "setup_s"}
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "stream.batch_p90_ms", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "stream", "moves": "bases_per_s",
         "workloads": ["ont.t4"]}])
    for cell, has in (("ont.t4", True), ("ont.t1", False)):
        layer = {m["name"] for m in registry.metrics_for(cell, bench,
                                                         "per_layer")}
        assert ("stream.batch_p90_ms" in layer) == has
        assert "device.idle" in layer


def test_a_new_config_traffic_and_metric_are_new_files_only(tmp_path,
                                                            monkeypatch):
    """A copy of the benchmark's folder, with one file added of each kind
    and an entry added to BENCHMARK.json, finds each by its name."""
    here = tmp_path / "bench_port"
    shutil.copytree(registry.HERE, here,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    cfg = json.loads((here / "configs" / "ont_chr20.json").read_text())
    cfg["name"] = "ont_small"
    (here / "configs" / "ont_small.json").write_text(json.dumps(cfg))
    (here / "traffic" / "t2.json").write_text(json.dumps(
        {"loop": "closed", "workers": 2, "batch_reads": 64,
         "warm_batches": 3}))
    (here / "metrics" / "stream.batches.py").write_text(
        "def read(rec):\n    return rec.batches\n")
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "ont_small.t2", "config": "ont_small", "traffic": "t2",
         "chips": 1, "why": "a test"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "stream.batches", "unit": "batches", "better": "higher",
         "source": "host_clock", "layer": "stream", "moves": "bases_per_s"}]
    monkeypatch.setattr(registry, "HERE", str(here))
    cell = registry.cell("ont_small.t2", bench)
    assert registry.config(cell["config"])["name"] == "ont_small"
    assert registry.traffic(cell["traffic"])["workers"] == 2
    names = [m["name"] for m in registry.metrics_for("ont_small.t2", bench,
                                                     "per_layer")]
    assert "stream.batches" in names

    class Rec:
        batches = 17
    assert registry.reader("stream.batches").read(Rec()) == 17
    (here / "roofline" / "k9_new.py").write_text(
        "SITES = ()\nDEVICE = ('new_kernel',)\n\ndef bound(a, k, o):\n"
        "    return 1.0, 2.0\n")
    assert "k9_new" in registry.rooflines()


def test_unknown_names_stop_the_run():
    with pytest.raises(SystemExit):
        registry.cell("no.such", BENCH)
    with pytest.raises(SystemExit):
        registry.config("no_such")
    with pytest.raises(SystemExit):
        registry.reader("no.such")
