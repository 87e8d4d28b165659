"""The import guard, and the runs that must print no result."""

import json
import os
import shutil
import subprocess
import sys

from bench_port import guard, registry


def test_whole_top_level_names():
    assert guard.loaded({"lra_tpu_torch": 1, "lra_tpu_torch.ops": 1,
                         "numpy": 1, "jaxtyping": 1, "lra_tpux": 1}) == []
    assert guard.loaded({"jax": 1, "jaxlib.xla": 1, "flax.linen": 1,
                         "lra_tpu.ops.sdp": 1, "lra_tpu": 1}) == [
        "flax.linen", "jax", "jaxlib.xla", "lra_tpu", "lra_tpu.ops.sdp"]


def _run(cmd, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import bench_port.run, bench_port.check, bench_port.harness;"
            "import lra_tpu_torch.pipeline.stream, lra_tpu_torch.cli;"
            "from bench_port import guard, registry;"
            "[registry.reader(m['name']) for m in "
            "registry.benchmark()['per_layer']]; registry.rooflines();"
            "print(guard.loaded())")
    p = _run([sys.executable, "-c", code], registry.ROOT)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_no_card_no_result():
    p = _run([sys.executable, "bench_port/run.py", "--workload", "ont.t1",
              "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
             registry.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    p = _run(bench["command"] + ["--workload", "ont.t1", "--seed", "1",
                                 "--seconds", "1", "--trace", "0"],
             tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
