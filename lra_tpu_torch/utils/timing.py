"""Per-stage timing (reference: Timing.h:9-66).

``Timing`` accumulates wall-clock per labeled stage across reads/batches;
``merge`` combines instances (the reference merges per-thread timers,
lra.cpp:708-713); ``write`` emits the --timing report.  Batch pipelines
tick once per stage per batch.

Thread-safe: the in-flight stage timestamp is thread-local (each worker
thread of a pipelined ``align_stream`` measures its own batch's stage
deltas), and the shared totals are mutated under a lock — so ``--timing``
reports accumulated per-batch stage time even when batches overlap.  In a
pipelined run the TOTAL therefore exceeds wall-clock (it sums concurrent
threads, exactly like the reference's merged per-thread timers).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict


class Timing:
    def __init__(self):
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: "OrderedDict[str, int]" = OrderedDict()
        self._tls = threading.local()
        self._lock = threading.Lock()

    def start(self) -> None:
        self._tls.last = time.perf_counter()

    def tick(self, label: str) -> None:
        now = time.perf_counter()
        last = getattr(self._tls, "last", now)
        self.add(label, now - last)
        self._tls.last = now

    def add(self, label: str, seconds: float) -> None:
        with self._lock:
            self.totals[label] = self.totals.get(label, 0.0) + seconds
            self.counts[label] = self.counts.get(label, 0) + 1

    def merge(self, other: "Timing") -> None:
        with self._lock:
            for k, v in other.totals.items():
                self.totals[k] = self.totals.get(k, 0.0) + v
                self.counts[k] = (self.counts.get(k, 0)
                                  + other.counts.get(k, 0))

    def elapsed(self) -> float:
        return sum(self.totals.values())

    def write(self, path_or_file) -> None:
        close = False
        f = path_or_file
        if isinstance(path_or_file, str):
            f = open(path_or_file, "w")
            close = True
        total = self.elapsed() or 1.0
        f.write("stage\tseconds\tcalls\tfraction\n")
        for k, v in self.totals.items():
            f.write(f"{k}\t{v:.4f}\t{self.counts.get(k, 0)}\t{v/total:.3f}\n")
        f.write(f"TOTAL\t{total:.4f}\t\t1.000\n")
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
