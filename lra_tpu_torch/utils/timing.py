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
    device-stream time (``stage_ms``) as well as host wall time."""

    def __init__(self):
        super().__init__()
        self.events: list = []

    def _mark(self, label: str) -> None:
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((label, ev))

    def start(self) -> None:
        super().start()
        self.events = []
        self._mark("start")

    def tick(self, label: str) -> None:
        super().tick(label)
        self._mark(label)

    def stage_ms(self) -> "OrderedDict[str, float]":
        """{label: ms between the previous event and this one}, summed
        over repeated labels; synchronizes the device first."""
        import torch

        torch.cuda.synchronize()
        out: "OrderedDict[str, float]" = OrderedDict()
        for (_, a), (label, b) in zip(self.events, self.events[1:]):
            out[label] = out.get(label, 0.0) + a.elapsed_time(b)
        return out
