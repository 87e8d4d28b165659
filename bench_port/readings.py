"""Readings of the output check's numbers over many seeds in one process,
at a cell's own size, from which its limits are set (PERF.md):

    python bench_port/readings.py --workload <cell> --seeds <a,b,...> \
        --seconds <s>

For each seed, a window of ``--seconds`` on the cell's own traffic and
pool (set-up, the index and the warm-up are shared), then the check of
what the window produced: as it came (the sound reading), with the
reference in bfloat16 in the kernels' place (the control), and with each
fault of faults.py planted in its SAM lines.  One JSON line a seed, then
a summary: each number's largest sound reading and its smallest under
the control and under each fault.  The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import guard, registry, run   # noqa: E402


def main(argv=None, device: str = "cuda", cfg: dict | None = None,
         traffic: dict | None = None, cache: bool = True) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--controls", type=int, default=3,
                   help="seeds (the first ones) checked under the control")
    args = p.parse_args(argv)
    cell = registry.cell(args.workload, registry.benchmark())
    cfg = cfg or registry.config(cell["config"])
    traffic = traffic or registry.traffic(cell["traffic"])
    run.cache_dirs()

    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        print("readings: not enough CUDA devices", file=sys.stderr)
        return 2

    from bench_port import check, faults, harness

    if device == "cuda":
        from lra_tpu_torch.ops import _ext

        _ext.build_all()
    seeds = [int(s) for s in args.seeds.split(",")]
    setup = harness.Setup(cfg, traffic, seeds[0], device, cache)
    setup.warm_up()
    kernels = registry.rooflines()
    rows = []
    for n, seed in enumerate(seeds):
        if seed != setup.seed:
            setup.seed = seed
            setup.pool = setup._batches(
                int(cfg["pool_batches"]), int(traffic["batch_reads"]),
                harness.rng_for(seed, harness.POOL), "r")
        capture = harness.Capture(kernels, harness.rng_for(seed,
                                                           harness.CAPTURE))
        window = harness.Window(setup, args.seconds)
        with capture:
            capture.on = True
            window.run()
            if device == "cuda":
                torch.cuda.synchronize()
            capture.on = False
        row = {"seed": seed, "batches": len(window.batches)}
        for label, control in (("sound", None), ("bf16", "bf16")):
            if control and n >= args.controls:
                continue
            _ok, _missing, compared = check.run(setup, window, capture, seed,
                                                control)
            row[label] = {k: v for k, v, _lim in compared}
        sound_lines = window.lines
        for name in faults.FAULTS:
            faults.plant(name, window)
            row[name] = check.sam_check(setup, window, seed)
            window.lines = sound_lines
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = {"sound_max": {k: max(r["sound"][k] for r in rows)
                             for k in check.LIMITS}}
    for label in ("bf16", *faults.FAULTS):
        have = [r[label] for r in rows if label in r]
        summary[f"{label}_min"] = {k: min(r[k] for r in have)
                                   for k in check.LIMITS if k in have[0]}
    found = guard.loaded()
    if found:
        print("readings: JAX or the JAX package was loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
