"""Per-stage timing (reference: Timing.h:9-66) and the span recorder.

``Timing`` accumulates wall-clock and thread CPU time per labeled stage
across reads/batches; ``merge`` combines instances (the reference merges
per-thread timers, lra.cpp:708-713); ``write`` emits the --timing
report.  Batch pipelines tick once per stage per batch.

Thread-safe: the in-flight stage timestamp is thread-local (each worker
thread of a pipelined ``align_stream`` measures its own batch's stage
deltas), and the shared totals are mutated under a lock — so ``--timing``
reports accumulated per-batch stage time even when batches overlap.  In a
pipelined run the TOTAL therefore exceeds wall-clock (it sums concurrent
threads, exactly like the reference's merged per-thread timers).  A
stage's CPU seconds are its own thread's (``time.thread_time``): under
the ``-t N`` pool, wall minus CPU is the time the thread waited, on the
device or on the interpreter lock.

``RECORDER`` keeps spans in memory while it is on, at three layers of a
batch: the batch (``pipeline.align_reads``), its stages (one span per
``Timing.tick``) and its device rounds (``utils/devstats.Round``: the
round and its pack / wait / copy / post phases).  A span has an id, its
parent's id, its batch's id, its thread, its name, its bounds on
``time.perf_counter_ns`` and its thread's CPU nanoseconds over it.  Off,
each hook costs one attribute test.  It is on from import when
``LRA_TPU_DEVSTATS`` is set, as devstats is, and ``devstats.reset()``
drops the spans kept so far; so a run with device-round statistics has
the spans of the rounds it records.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict


class Span:
    """One recorded interval.  ``kind`` is "batch", "stage", "round" or
    "phase"; ``counts`` is a dict of counts, or None."""

    __slots__ = ("id", "parent", "batch", "thread", "kind", "name", "t0_ns",
                 "t1_ns", "cpu_ns", "counts")

    def __init__(self, id, parent, batch, thread, kind, name, t0_ns,
                 t1_ns=0, cpu_ns=0, counts=None):
        self.id, self.parent, self.batch = id, parent, batch
        self.thread, self.kind, self.name = thread, kind, name
        self.t0_ns, self.t1_ns, self.cpu_ns = t0_ns, t1_ns, cpu_ns
        self.counts = counts

    @property
    def wall_ns(self) -> int:
        return self.t1_ns - self.t0_ns

    def __repr__(self) -> str:
        return (f"Span({self.kind} {self.name!r} id={self.id} "
                f"parent={self.parent} batch={self.batch} "
                f"wall_ns={self.wall_ns} cpu_ns={self.cpu_ns})")


class Recorder:
    """The process-wide span recorder (``RECORDER``).

    Per thread it keeps the stack of open spans, the outermost being the
    thread's batch.  A stage's label is known only when ``Timing.tick``
    closes it, so the spans a thread opens in its batch since its last
    tick are re-parented to the stage span that the next tick makes."""

    def __init__(self):
        self.on = False
        self._spans: list = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._batches = itertools.count()
        self._devstats_was = None

    def start(self) -> None:
        """Drop the spans kept so far and record from now on, with the
        device-round statistics on (``stop`` restores their switch)."""
        from . import devstats

        self.clear()
        if not self.on:
            self._devstats_was = devstats.ENABLED
        devstats.ENABLED = True
        self.on = True

    def stop(self) -> list:
        """Stop recording; returns the spans kept since ``start``."""
        from . import devstats

        self.on = False
        if self._devstats_was is not None:
            devstats.ENABLED, self._devstats_was = self._devstats_was, None
        with self._lock:
            out, self._spans = self._spans, []
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans = []

    def spans(self) -> list:
        """The spans kept so far; recording goes on."""
        with self._lock:
            return list(self._spans)

    def batch_id(self) -> int:
        """The next free batch id."""
        return next(self._batches)

    def _thread(self):
        tls = self._tls
        if not hasattr(tls, "stack"):
            tls.stack, tls.batch, tls.loose = [], None, []
        return tls

    def _keep(self, sp: Span) -> Span:
        with self._lock:
            self._spans.append(sp)
        return sp

    def open(self, kind: str, name: str, t0_ns: int) -> Span:
        """A span of this thread from ``t0_ns`` until ``close``, child of
        the thread's innermost open span."""
        tls = self._thread()
        parent = tls.stack[-1] if tls.stack else None
        sp = Span(next(self._ids), parent.id if parent else None,
                  tls.batch.batch if tls.batch else None,
                  threading.get_ident(), kind, name, t0_ns,
                  cpu_ns=time.thread_time_ns())
        if parent is not None and parent is tls.batch:
            tls.loose.append(sp)
        tls.stack.append(sp)
        return sp

    def close(self, sp: Span, t1_ns: int, counts=None) -> None:
        stack = self._thread().stack
        if sp in stack:
            stack.remove(sp)
        sp.t1_ns, sp.counts = t1_ns, counts
        sp.cpu_ns = time.thread_time_ns() - sp.cpu_ns
        self._keep(sp)

    def child(self, parent: Span, name: str, t0_ns: int, t1_ns: int,
              cpu_ns: int, counts=None) -> Span:
        """A phase of ``parent`` from bounds already taken."""
        return self._keep(Span(next(self._ids), parent.id, parent.batch,
                               parent.thread, "phase", name, t0_ns, t1_ns,
                               cpu_ns, counts))

    def open_batch(self, batch_id=None) -> Span:
        """This thread's batch span, the outermost (what an earlier batch
        of the thread left open is dropped); ``batch_id`` None takes the
        next free id."""
        tls = self._thread()
        tls.stack, tls.batch, tls.loose = [], None, []
        sp = self.open("batch", "batch", time.perf_counter_ns())
        sp.batch = self.batch_id() if batch_id is None else batch_id
        tls.batch = sp
        return sp

    def close_batch(self, sp: Span, **counts) -> None:
        self.close(sp, time.perf_counter_ns(), counts)
        tls = self._thread()
        tls.stack, tls.batch, tls.loose = [], None, []

    def stage(self, label: str, t0_ns: int, t1_ns: int, cpu_ns: int) -> None:
        """The stage ``Timing.tick`` just closed on this thread: a child
        of the thread's batch, parent of the spans opened since."""
        tls = self._thread()
        b = tls.batch
        sp = Span(next(self._ids), b.id if b else None,
                  b.batch if b else None, threading.get_ident(), "stage",
                  label, t0_ns, t1_ns, cpu_ns)
        for child in tls.loose:
            child.parent = sp.id
        tls.loose = []
        self._keep(sp)


RECORDER = Recorder()
RECORDER.on = bool(os.environ.get("LRA_TPU_DEVSTATS"))


class Timing:
    def __init__(self):
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: "OrderedDict[str, int]" = OrderedDict()
        self.cpu: "OrderedDict[str, float]" = OrderedDict()
        self._tls = threading.local()
        self._lock = threading.Lock()

    def start(self) -> None:
        self._tls.last = time.perf_counter()
        self._tls.cpu = time.thread_time_ns()

    def tick(self, label: str) -> None:
        now_ns, cpu = time.perf_counter_ns(), time.thread_time_ns()
        now = now_ns / 1e9
        last = getattr(self._tls, "last", now)
        last_cpu = getattr(self._tls, "cpu", cpu)
        self.add(label, now - last, (cpu - last_cpu) / 1e9)
        if RECORDER.on:
            RECORDER.stage(label, round(last * 1e9), now_ns, cpu - last_cpu)
        self._tls.last, self._tls.cpu = now, cpu

    def add(self, label: str, seconds: float,
            cpu_seconds: float = 0.0) -> None:
        with self._lock:
            self.totals[label] = self.totals.get(label, 0.0) + seconds
            self.counts[label] = self.counts.get(label, 0) + 1
            self.cpu[label] = self.cpu.get(label, 0.0) + cpu_seconds

    def merge(self, other: "Timing") -> None:
        with self._lock:
            for k, v in other.totals.items():
                self.totals[k] = self.totals.get(k, 0.0) + v
                self.counts[k] = (self.counts.get(k, 0)
                                  + other.counts.get(k, 0))
                self.cpu[k] = self.cpu.get(k, 0.0) + other.cpu.get(k, 0.0)

    def elapsed(self) -> float:
        return sum(self.totals.values())

    def write(self, path_or_file) -> None:
        close = False
        f = path_or_file
        if isinstance(path_or_file, str):
            f = open(path_or_file, "w")
            close = True
        total = self.elapsed() or 1.0
        f.write("stage\tseconds\tcalls\tfraction\tcpu_seconds\n")
        for k, v in self.totals.items():
            f.write(f"{k}\t{v:.4f}\t{self.counts.get(k, 0)}\t{v/total:.3f}"
                    f"\t{self.cpu.get(k, 0.0):.4f}\n")
        f.write(f"TOTAL\t{total:.4f}\t\t1.000\t"
                f"{sum(self.cpu.values()):.4f}\n")
        if close:
            f.close()


class CudaEventTiming(Timing):
    """Timing that also records a CUDA event on the current stream at
    start() and at every tick(), so each stage's time can be read as
    device-stream time (``stage_ms``) as well as host wall time.

    One instance may be shared by the threads of a pipelined
    ``align_stream``, each running its batches on its own stream: every
    start() opens a new event list, owned by the calling thread and
    recorded on its current stream, and a stage is the time between two
    consecutive events of one list only."""

    def __init__(self):
        super().__init__()
        self.lists: list = []       # (thread name, [(label, event)]) per start

    def _mark(self, label: str) -> None:
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._tls.events.append((label, ev))

    def start(self) -> None:
        super().start()
        self._tls.events = []
        with self._lock:
            self.lists.append((threading.current_thread().name,
                               self._tls.events))
        self._mark("start")

    def tick(self, label: str) -> None:
        super().tick(label)
        self._mark(label)

    def thread_stage_ms(self) -> "OrderedDict[str, OrderedDict]":
        """{thread name: {label: ms between the previous event of the same
        list and this one}}, summed over repeated labels and over the
        thread's lists; waits for each list's last event (its stream
        only)."""
        with self._lock:
            lists = list(self.lists)
        out: "OrderedDict[str, OrderedDict]" = OrderedDict()
        for name, events in lists:
            if not events:
                continue
            events[-1][1].synchronize()
            st = out.setdefault(name, OrderedDict())
            for (_, a), (label, b) in zip(events, events[1:]):
                st[label] = st.get(label, 0.0) + a.elapsed_time(b)
        return out

    def stage_ms(self) -> "OrderedDict[str, float]":
        """{label: ms}, thread_stage_ms summed over the threads."""
        out: "OrderedDict[str, float]" = OrderedDict()
        for st in self.thread_stage_ms().values():
            for label, ms in st.items():
                out[label] = out.get(label, 0.0) + ms
        return out
