"""Find the benchmark's pieces by name, so that adding one is adding files.

* a cell: an entry of ``workloads`` in BENCHMARK.json (at the checkout's
  root), naming a configuration and a traffic mix;
* a configuration: ``configs/<name>.json``;
* a traffic mix: ``traffic/<name>.json``;
* a per-layer metric: ``metrics/<name>.py``, a module with ``read(rec)``
  that returns a number, or None when the run holds nothing to read;
* a kernel's roofline: ``roofline/<kernel>.py``, a module with ``SITES``
  (the program's modules and names through which the kernel's wrapper is
  called), ``DEVICE`` (substrings of the CUDA kernels' names it
  launches) and ``bound(args, kw, out)`` (the operations and bytes that
  a call's real problems need).
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    if not os.path.exists(path):
        raise SystemExit(f"no {kind} file for {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(cell_name: str, bench: dict, kind: str) -> list:
    """The cell's metrics of one kind ("end_to_end" or "per_layer"):
    those with no ``workloads`` key, and those that list the cell."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def _module(path: str, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The reader of per-layer metric ``name`` (metrics/<name>.py)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise SystemExit(f"no reader for metric {name!r} ({path})")
    return _module(path, "bench_port_metric_" + name.replace(".", "_"))


def rooflines() -> dict:
    """{kernel name: module} of every file under roofline/."""
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "roofline", "*.py"))):
        name = os.path.basename(path)[:-3]
        if not name.startswith("_"):
            out[name] = _module(path, "bench_port_roofline_" + name)
    return out
