"""The benchmark of lra_tpu_torch, one run of one cell:

    python bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Set-up builds (or finds cached) the kernels and the index, makes
the read pool from the seed and warms up; the window then drives
``align_stream`` for ``--seconds``; the output check holds what the
window produced to the plain reference.  The last line of standard
output is one JSON object: ``correct``, ``attempted`` (reads submitted),
``failed`` (reads with no record), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, last,
``checks``: each number compared with its limit.  No result is printed,
and the exit code is not 0, without enough CUDA devices, or when a module
of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse   # noqa: E402
import contextlib  # noqa: E402
import gc         # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import resource   # noqa: E402
import sys        # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import guard, registry   # noqa: E402


def process_start() -> float:
    """The perf_counter time at which this process started (from
    /proc/self/stat), or the time this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def cache_dirs() -> None:
    """Fixed build and kernel cache directories inside the checkout."""
    base = os.path.join(registry.HERE, ".cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bf16",), default=None,
                   help="put the reference in bfloat16 in the kernels' "
                        "place in the output check (must come out not "
                        "correct); not used by the benchmark's runs")
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda", bench: dict | None = None,
         cfg: dict | None = None, traffic: dict | None = None,
         cache: bool = True) -> int:
    """One run.  The CPU tests pass ``device="cpu"`` (the kernels' plain
    twins), their own small configuration and traffic, and no cache."""
    t_start = process_start()
    args = parse(argv)
    bench = bench or registry.benchmark()
    cell = registry.cell(args.workload, bench)
    cfg = cfg or registry.config(cell["config"])
    traffic = traffic or registry.traffic(cell["traffic"])
    cache_dirs()
    if args.trace:
        os.environ["LRA_TPU_DEVSTATS"] = "1"     # read when devstats loads

    import torch

    if device == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < int(cell["chips"]):
            print(f"bench_port: {cell['name']} needs {cell['chips']} CUDA "
                  f"device(s), found {n}", file=sys.stderr)
            return 2

    from bench_port import check, harness
    from bench_port.harness import log

    if device == "cuda":
        from lra_tpu_torch.ops import _ext

        built = _ext.build_all()
        if built:
            log("built " + ", ".join(f"{k} {v:.1f} s"
                                     for k, v in built.items()))
    setup = harness.Setup(cfg, traffic, args.seed, device, cache)
    setup.warm_up()
    # the read pool and the index live through the run: keep the
    # collector from walking them inside the window
    gc.collect()
    gc.freeze()
    kernels = registry.rooflines()
    capture = harness.Capture(kernels, harness.rng_for(args.seed,
                                                       harness.CAPTURE),
                              keep_all=bool(args.trace))
    timing = harness.span_timing() if args.trace else None
    window = harness.Window(setup, args.seconds, timing)
    if device == "cuda":
        torch.cuda.synchronize()
    tracer = contextlib.nullcontext()
    if args.trace:
        from lra_tpu_torch.utils import devstats
        from torch.profiler import ProfilerActivity, profile

        devstats.reset()
        tracer = profile(activities=[ProfilerActivity.CUDA if device == "cuda"
                                     else ProfilerActivity.CPU])
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    with capture, tracer as prof:
        capture.on = True
        t_enter = time.perf_counter()
        wall_ns, mono_ns = time.time_ns(), time.monotonic_ns()
        window.run()
        if device == "cuda":
            torch.cuda.synchronize()
        capture.on = False
        t_close = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    setup_s = window.t0 - t_start
    wall = window.wall
    bases = window.bases()
    log(f"window: {len(window.batches)} batches, {bases} bases in "
        f"{wall:.3f} s (closed {t_close - window.t0:.3f} s after the first "
        "submission)")
    log_host(ru0, window)

    result_metrics = {}
    extra = {}
    if not args.trace:
        lat = window.latencies_ms()
        values = {"bases_per_s": bases / wall, "setup_s": setup_s}
        log(f"batch latency ms: median {np.median(lat):.1f}, p90 "
            f"{np.percentile(lat, 90):.1f}, max {lat.max():.1f}, "
            f"{len(lat)} batches")
        for m in registry.metrics_for(cell["name"], bench, "end_to_end"):
            result_metrics[m["name"]] = {"value": values[m["name"]],
                                         "unit": m["unit"]}
    else:
        rec, extra = traced_records(prof, t_enter, wall_ns, mono_ns, window,
                                    timing, capture, kernels)
        for m in registry.metrics_for(cell["name"], bench, "per_layer"):
            v = registry.reader(m["name"]).read(rec)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            log(f"{m['name']}: {v}")

    correct, failed, compared = check.run(setup, window, capture, args.seed,
                                          args.control)
    found_mods = guard.loaded()
    if found_mods:
        print("bench_port: JAX or the JAX package was loaded: "
              + ", ".join(found_mods), file=sys.stderr)
        return 3
    for k, v, lim in compared:
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    attempted = sum(len(b) for b in window.batches)
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": int(failed), "metrics": result_metrics,
           "device": {"platform": "gpu" if device == "cuda" else device,
                      "kind": (torch.cuda.get_device_name(0)
                               if device == "cuda" else device),
                      "count": int(cell["chips"]),
                      "memory_peak_bytes": int(peak)}}
    out["device"].update(extra.get("device", {}))
    if "breakdown" in extra:
        out["breakdown"] = extra["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in compared}
    print(json.dumps(out), flush=True)
    return 0


def log_host(ru0, window) -> None:
    """What the host did in the window: the process's CPU seconds and
    context switches, and the rate of each sixth of the window (a stall
    shows in one sixth, a slow host in all)."""
    from bench_port.harness import log

    ru = resource.getrusage(resource.RUSAGE_SELF)
    cpu = (ru.ru_utime + ru.ru_stime) - (ru0.ru_utime + ru0.ru_stime)
    mb = window.bases() / 1e6
    log(f"host: cpu {cpu:.3f} s ({cpu / window.wall:.3f} cores, "
        f"{cpu / mb:.4f} s/Mb), context switches "
        f"{ru.ru_nvcsw - ru0.ru_nvcsw} voluntary, "
        f"{ru.ru_nivcsw - ru0.ru_nivcsw} involuntary")
    done = np.array(window.done) - window.t0
    per = np.array([sum(len(r.codes) for r in b) for b in window.batches])
    edges = np.linspace(0.0, window.wall, 7)
    rates = [per[(done > a) & (done <= b)].sum() / (b - a) / 1e6
             for a, b in zip(edges[:-1], edges[1:])]
    log("rate by sixth of the window (Mb/s): "
        + " ".join(f"{r:.4f}" for r in rates))


def traced_records(prof, t_enter, wall_ns, mono_ns, window, timing, capture,
                   kernels):
    """The Records the per-layer readers read, and the result's traced
    extras (busy_s, window_s, breakdown)."""
    from bench_port import harness, peaks
    from lra_tpu_torch.utils import devstats

    span = (window.t0, window.done[-1])
    ops = harness.device_intervals(prof, t_enter, wall_ns, mono_ns)
    inside = [(max(s, span[0]), min(e, span[1])) for _n, s, e in ops
              if min(e, span[1]) > max(s, span[0])]
    busy = sum(e - s for s, e in harness.union(inside))
    hand = harness.hand_kernels(ops, span, kernels)
    bound_s = {k: 0.0 for k in kernels}
    launches = {k: 0 for k in kernels}
    for name, (args, kw, out) in capture.all:
        a = harness.to_host(list(args))
        k = {kk: harness.to_host(v) for kk, v in kw.items()}
        o = harness.to_host(out)
        bound_s[name] += peaks.roofline_s(*kernels[name].bound(a, k, o))
        launches[name] += 1
    card = harness.power_limit()
    harness.log(f"card: {card}; device ops {len(ops)}, busy {busy:.4f} s of "
                f"{span[1] - span[0]:.3f} s")
    for k in kernels:
        harness.log(f"  {k}: {launches[k]} launches, device "
                    f"{1e3 * hand[k]:.3f} ms, bound {1e3 * bound_s[k]:.3f} ms")
    rec = harness.Records(
        window_s=span[1] - span[0], bases=window.bases(),
        batches=len(window.batches), latencies_ms=window.latencies_ms(),
        stage_totals=dict(timing.totals),
        devstats=devstats.report(), busy_s=busy, hand_device_s=hand,
        hand_bound_s=bound_s, launches=launches, card=card)
    extra = {"device": {"busy_s": busy, "window_s": span[1] - span[0]},
             "breakdown": harness.breakdown(ops, span, timing.spans)}
    return rec, extra


if __name__ == "__main__":
    sys.exit(main())
