#!/usr/bin/env python3
"""The longest idle gaps of the card in a traced benchmark run, named by
the program's own spans.

    python3 tools/trace_gaps.py --workload ont.t4 --seed 7 --seconds 51

runs ``bench_port/run.py`` with ``--trace 1`` in this process (its output
as it is) and then prints to standard error the ten longest gaps between
device activities inside the window.  For each, every thread with a span
across the gap's middle gives its deepest such span (a round's phase,
say ``gap_align.pack``, before its round, its stage and its batch) and
that span's CPU share (its thread's CPU time over its wall), and then
each device round tag's counts, summed over the window.  The spans
are ``lra_tpu_torch/utils/timing.RECORDER``'s, which the traced run keeps
on (it sets ``LRA_TPU_DEVSTATS``).
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def idle_gaps(ops: list, window: tuple, n: int = 10) -> list:
    """The ``n`` longest (start, end) stretches of ``window`` in which no
    device activity (name, start, end) runs, longest first."""
    from bench_port.harness import union

    t0, t1 = window
    busy = union([(max(s, t0), min(e, t1)) for _n, s, e in ops
                  if min(e, t1) > max(s, t0)])
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    return sorted(gaps, key=lambda g: g[0] - g[1])[:n]


def open_spans(spans: list, t_ns: int) -> dict:
    """{thread: its deepest span open at ``t_ns``} (depth: the length of
    the span's chain of parents)."""
    by_id = {s.id: s for s in spans}

    def depth(s):
        d = 0
        while s.parent in by_id:
            s, d = by_id[s.parent], d + 1
        return d

    out: dict = {}
    for s in spans:
        if s.t0_ns <= t_ns < s.t1_ns:
            best = out.get(s.thread)
            if best is None or depth(s) > depth(best):
                out[s.thread] = s
    return out


def name_gaps(gaps: list, spans: list, t_origin: float) -> list:
    """One line per gap: its length and start in the window, then each
    thread's deepest open span and that span's CPU share."""
    first = sorted(spans, key=lambda s: s.t0_ns)
    threads = {th: k + 1 for k, th in enumerate(
        dict.fromkeys(s.thread for s in first))}
    lines = []
    for g0, g1 in gaps:
        mid = int(round((g0 + g1) / 2 * 1e9))
        named = sorted(open_spans(spans, mid).items(),
                       key=lambda kv: threads[kv[0]])
        what = "; ".join(
            f"T{threads[th]} {s.name} "
            f"({100 * s.cpu_ns / max(1, s.wall_ns):.0f} % CPU)"
            for th, s in named) or "no span open"
        lines.append(f"{g1 - g0:.4f} s @{g0 - t_origin:.3f} s: {what}")
    return lines


def main(argv=None, **run_kw) -> int:
    """``run_kw`` goes to ``bench_port.run.main`` (the CPU tests pass a
    device, configuration and traffic of their own)."""
    from bench_port import harness, run

    seen: dict = {}
    breakdown = harness.breakdown

    def keep(ops, window, spans):
        seen["ops"], seen["window"] = ops, window
        return breakdown(ops, window, spans)

    harness.breakdown = keep
    try:
        rc = run.main([*(sys.argv[1:] if argv is None else argv),
                       "--trace", "1"], **run_kw)
    finally:
        harness.breakdown = breakdown
    from lra_tpu_torch.utils.timing import RECORDER

    spans = RECORDER.spans()
    if rc != 0 or "window" not in seen:
        return rc
    harness.log(f"the ten longest idle gaps, by the program's spans "
                f"({len(spans)} spans):")
    for line in name_gaps(idle_gaps(seen["ops"], seen["window"]), spans,
                          seen["window"][0]):
        harness.log("  " + line)
    harness.log("the window's device rounds, by tag (their spans' counts):")
    for line in round_counts(spans):
        harness.log("  " + line)
    return rc


def round_counts(spans: list) -> list:
    """One line per round tag: its rounds and each count its round spans
    carry (buckets, jobs, launches; the alignment rounds' table_rows,
    object_rows and host_rows), summed over the window."""
    agg: dict = {}
    for s in spans:
        if s.kind == "round":
            a = agg.setdefault(s.name, {"rounds": 0})
            a["rounds"] += 1
            for k, v in (s.counts or {}).items():
                a[k] = a.get(k, 0) + v
    return [f"{tag}: " + ", ".join(f"{k} {v}" for k, v in a.items())
            for tag, a in agg.items()]


if __name__ == "__main__":
    sys.exit(main())
