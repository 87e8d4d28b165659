"""Opt-in per-device-round statistics (set LRA_TPU_DEVSTATS=1).

Each batched device round (chain SDP, gap align, refine boxes, indel
refine) records one event:

* ``buckets``, ``jobs`` (and ``small_jobs`` for the alignment rounds);
* ``pack_s``: host time from the round's entry until every bucket is
  launched (host packing, host-to-device copies, the kernel wrappers);
* ``compute_s``: on a CUDA device, the device time of the round's kernel
  launches, between CUDA events recorded on the calling thread's stream
  just before and just after each launch, read after waiting on the last
  of them (that stream only, never the whole device).  On the CPU the
  kernels' plain twins run inside their calls, so their time is in
  ``pack_s``, and ``compute_s`` is the host time spent waiting for the
  results after the last launch, as on lra_tpu's CPU backend;
* ``copy_s``: the one device-to-host copy of the round's results;
* ``post_s``: host decoding of the results;
* ``bytes``: the size of that copy.

Three more keys, not in lra_tpu's table: ``launch_s``, the part of
``pack_s`` spent inside the kernels' C entry points (shared-memory
attributes, occupancy lookups, counter memsets, the launches);
``host_s``, the part of ``pack_s`` spent on the alignment rounds' host
jobs, which run after the launches while the device works; and
``launches``.

``report()`` aggregates per round tag.  When disabled the hooks cost one
branch each: no event, no synchronisation.  Rounds of several threads
(the ``-t N`` pool) record at once: each thread keeps its own round open
and appends under a lock.

``LRA_TPU_DEVSTATS`` gives ``ENABLED`` its value at import; every hook
reads ``ENABLED`` when it is called, so code may switch it at run time.
While the span recorder (``utils/timing.RECORDER``) is on, it keeps
devstats on, and each round is a span named by its tag with four
phases, ``<tag>.pack`` (entry to ``launched``; counts ``launch_s``,
``host_s``), ``<tag>.wait`` (``launched``'s wait for the device),
``<tag>.copy`` (to ``copied``; empty when nothing was copied) and
``<tag>.post`` (to ``record``); the round counts its ``buckets``,
``jobs`` and ``launches``.  A round may also name a part of its host
work (``Round.part``), a further child span of the round, inside one of
its phases: the alignment rounds' ``<tag>.host`` (their host fallback
rows) and the chaining round's ``chain_sdp.far`` (the windowed kernel's
far schedules and sentinels).  ``reset()`` also drops the spans kept so
far.
"""

from __future__ import annotations

import os
import threading
import time

from .timing import RECORDER

ENABLED = bool(os.environ.get("LRA_TPU_DEVSTATS"))
EVENTS: list = []

_lock = threading.Lock()
_tls = threading.local()


def now() -> float:
    return time.perf_counter()


def clock() -> tuple:
    """(perf_counter ns, thread CPU ns) now: where a ``Round.part``
    starts."""
    return time.perf_counter_ns(), time.thread_time_ns()


def record(tag: str, **kw) -> None:
    if ENABLED:
        with _lock:
            EVENTS.append((tag, kw))


def reset() -> None:
    with _lock:
        EVENTS.clear()
    RECORDER.clear()


def report(out=None) -> dict:
    """Aggregate events per tag; print a table if ``out`` is given."""
    agg: dict = {}
    with _lock:
        events = list(EVENTS)
    for tag, kw in events:
        a = agg.setdefault(tag, {"rounds": 0})
        a["rounds"] += 1
        for k, v in kw.items():
            a[k] = a.get(k, 0) + v
    if out is not None:
        cols = ["rounds", "buckets", "jobs", "small_jobs", "pack_s",
                "compute_s", "copy_s", "post_s", "bytes"]
        out.write("round\t" + "\t".join(cols) + "\n")
        for tag, a in agg.items():
            row = [tag]
            for c in cols:
                v = a.get(c, 0)
                row.append(f"{v:.4f}" if isinstance(v, float) else str(v))
            out.write("\t".join(row) + "\n")
    return agg


class Round:
    """One device round on this thread, from its entry (construction) to
    ``record``; made only when ENABLED.  Kernel launches of the thread
    in between (``timed_launch``) are bracketed by CUDA events."""

    def __init__(self):
        t = time.perf_counter_ns()
        self.t_enter = self.t_post0 = t / 1e9
        self.pack_s = self.compute_s = self.copy_s = 0.0
        self.launch_s = self.host_s = 0.0
        self.nbytes = 0
        self.events: list = []          # (before, after) per launch
        self.outer = getattr(_tls, "round", None)
        _tls.round = self
        self.span = None
        if RECORDER.on:
            # (perf_counter ns, thread CPU ns) at each phase's start
            self.marks = {"pack": (t, time.thread_time_ns())}
            self.span = RECORDER.open("round", "round", t)

    def _mark(self, phase: str, t_ns: int) -> None:
        if self.span is not None:
            self.marks[phase] = (t_ns, time.thread_time_ns())

    def launched(self) -> None:
        """Every bucket is launched and the host jobs are done: wait for
        the last launch (its stream only) and read the launches' device
        time."""
        t0 = time.perf_counter_ns()
        self._mark("wait", t0)
        self.pack_s = t0 / 1e9 - self.t_enter
        if self.events:
            self.events[-1][1].synchronize()
            self.compute_s = sum(a.elapsed_time(b)
                                 for a, b in self.events) / 1e3
        t1 = time.perf_counter_ns()
        if not self.events:
            self.compute_s = (t1 - t0) / 1e9
        self.t_post0 = t1 / 1e9
        self._mark("copy", t1)

    def copied(self, nbytes: int) -> None:
        """The results' one device-to-host copy is done."""
        t_ns = time.perf_counter_ns()
        t = t_ns / 1e9
        self.copy_s, self.t_post0, self.nbytes = t - self.t_post0, t, nbytes
        self._mark("post", t_ns)

    def part(self, name: str, start: tuple, **counts) -> float:
        """Host work of the round from ``start`` (``clock()``) to now: a
        child span ``name`` of the round while the recorder is on, with
        ``counts``.  Returns its wall seconds."""
        t_ns = time.perf_counter_ns()
        if self.span is not None:
            RECORDER.child(self.span, name, start[0], t_ns,
                           time.thread_time_ns() - start[1], counts or None)
        return (t_ns - start[0]) / 1e9

    def record(self, tag: str, **kw) -> None:
        """Close the round: its host decoding ends now."""
        t_ns = time.perf_counter_ns()
        self._mark("end", t_ns)
        _tls.round = self.outer
        record(tag, **kw, pack_s=self.pack_s, compute_s=self.compute_s,
               copy_s=self.copy_s, post_s=t_ns / 1e9 - self.t_post0,
               bytes=self.nbytes, launch_s=self.launch_s,
               host_s=self.host_s, launches=len(self.events))
        if self.span is not None:
            self._spans(tag, t_ns, kw)

    def _spans(self, tag: str, t_ns: int, kw: dict) -> None:
        """The round's span and its four phases.  A round that never
        copied has an empty copy phase, and one that never launched empty
        pack, wait and copy phases, as their seconds are 0 in its event."""
        bounds = [self.marks["pack"]]
        for phase in ("wait", "copy", "post", "end"):
            bounds.append(self.marks.get(phase, bounds[-1]))
        for k, phase in enumerate(("pack", "wait", "copy", "post")):
            (a, ca), (b, cb) = bounds[k], bounds[k + 1]
            counts = ({"launch_s": self.launch_s, "host_s": self.host_s}
                      if phase == "pack" else None)
            RECORDER.child(self.span, f"{tag}.{phase}", a, b, cb - ca,
                           counts)
        self.span.name = tag
        RECORDER.close(self.span, t_ns, {**kw, "launches": len(self.events)})


def timed_launch(f, args, stream) -> int:
    """f(*args, stream handle) between two CUDA events on ``stream``,
    kept by this thread's open round (if any); returns f's code."""
    rnd = getattr(_tls, "round", None)
    if rnd is None:
        return f(*args, stream.cuda_stream)
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record(stream)
    t0 = now()
    rc = f(*args, stream.cuda_stream)
    rnd.launch_s += now() - t0
    b.record(stream)
    rnd.events.append((a, b))
    return rc
