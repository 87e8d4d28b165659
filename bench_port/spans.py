"""The program's own spans, as the per-layer readers of a traced run read
them.

The traced run sets ``LRA_TPU_DEVSTATS`` before the program loads and
calls ``devstats.reset()`` just before the window.  In a program that has
a span recorder (``lra_tpu_torch/utils/timing.RECORDER``), that keeps
spans from the program's start and drops those kept before the window,
so what it holds when the readers run is the window's batches: one
"batch" span each (``align_reads``), their "stage" spans (one per
``Timing.tick``, named by its label) and their device rounds, a "round"
span each with four "phase" spans (``<tag>.pack``, ``.wait``, ``.copy``,
``.post``).  A span has ``id``, ``parent``, ``batch``, ``thread``,
``kind``, ``name``, ``t0_ns``, ``t1_ns`` (``time.perf_counter_ns``) and
``cpu_ns`` (its thread's CPU time over it).

``Records.spans``, where a traced run provides it, is read first.  A
program without the recorder gives None, and so does every reader.
"""

from __future__ import annotations

from collections import OrderedDict

DEVICE = " (device)"


def of(rec):
    """The run's spans, or None when it holds none.  The first call on a
    run logs the per-stage table and the check of the stage spans
    against the Timing totals."""
    if "_program_spans" not in rec.__dict__:
        spans = getattr(rec, "spans", None)
        if spans is None:
            try:
                from lra_tpu_torch.utils.timing import RECORDER
            except ImportError:
                spans = None
            else:
                spans = RECORDER.spans()
        rec._program_spans = spans or None
        if rec._program_spans:
            log_tables(rec, rec._program_spans)
    return rec._program_spans


def of_kind(spans, kind: str) -> list:
    return [s for s in spans if s.kind == kind]


def per_name(spans) -> "OrderedDict[str, list]":
    """{name: [wall s, CPU s, calls]} in the order names first end."""
    out: "OrderedDict[str, list]" = OrderedDict()
    for s in sorted(spans, key=lambda s: s.t1_ns):
        row = out.setdefault(s.name, [0.0, 0.0, 0])
        row[0] += s.wall_ns / 1e9
        row[1] += s.cpu_ns / 1e9
        row[2] += 1
    return out


def check(rec, spans) -> list:
    """The labels whose stage spans' wall, summed, is not their Timing
    total to within 1 ms a batch: [(label, span s, Timing s)]."""
    walls = per_name(of_kind(spans, "stage"))
    tol = 1e-3 * max(1, rec.batches)
    labels = set(walls) | set(rec.stage_totals)
    return [(k, walls.get(k, [0.0])[0], rec.stage_totals.get(k, 0.0))
            for k in sorted(labels)
            if abs(walls.get(k, [0.0])[0]
                   - rec.stage_totals.get(k, 0.0)) > tol]


def log_tables(rec, spans) -> None:
    """Standard error: the stages', then the round phases', wall and CPU
    seconds per Mb and calls, and the check against the Timing totals."""
    from bench_port.harness import log

    mb = rec.mb or float("nan")
    for title, kind in (("stage", "stage"), ("round phase", "phase")):
        log(f"{title}\twall s/Mb\tCPU s/Mb\tcalls")
        for name, (wall, cpu, n) in per_name(of_kind(spans, kind)).items():
            log(f"  {name}\t{wall / mb:.4f}\t{cpu / mb:.4f}\t{n}")
    batches = of_kind(spans, "batch")
    log(f"spans: {len(spans)} in {len(batches)} batches "
        f"({sum((s.counts or {}).get('bases', 0) for s in batches)} bases;"
        f" the window's {rec.bases} in {rec.batches})")
    bad = check(rec, spans)
    if bad:
        log("spans: stage spans against the Timing totals FAILED: "
            + ", ".join(f"{k} {a:.6f} s against {b:.6f} s"
                        for k, a, b in bad))
    else:
        log("spans: stage spans equal the Timing totals of every label to "
            f"within 1 ms a batch ({len(rec.stage_totals)} labels)")
