"""Pipelined batch streaming: overlap host stages with device rounds.

The reference pipelines 1MB read batches against compute with a pthread
pool sharing one mutex-guarded reader and writer (reference:
lra.cpp:35,103-172,678-713).  Here a small thread pool runs
``align_reads`` on successive batches so that while batch k waits on a
device round, batch k+1's host stages (matching, clustering, chain
surgery, SAM assembly) run on the CPU — and vice versa.

On a CUDA device every worker thread makes its own ``torch.cuda.Stream``
once, when the pool starts it, and runs each of its batches on it: every
host-to-device copy, kernel launch (``ops/_ext.launch`` launches on the
calling thread's current stream), event and device-to-host copy of a
batch lies on its worker's stream, and a worker waits only on its own
stream (the ``.cpu()`` copies, ``Event.synchronize``), never on the
whole device.  A worker's tensors are allocated, used and freed on its
stream alone.  Host stages hold the GIL; the native host library and the
kernel launches (ctypes calls) release it.

Output order is preserved: results are yielded strictly in submission
order regardless of completion order.  While the span recorder
(utils/timing.py) is on, each batch takes its id as it is submitted
(run in turn, align_reads takes the next free id itself).
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor


def align_stream(batches, genome, index, opts, use_device=True,
                 genome_li=None, timing=None, dots=None, workers=2,
                 device="cuda"):
    """Yield (states, sam_lines) per batch, in order.

    batches: iterable of read batches (each a list of read tuples).
    device: where the device rounds run (as align_reads'); "cuda" gives
    every worker its own CUDA stream.
    workers <= 1, or a dots collector, degrades to sequential execution
    (per-read dot dumps are not thread-safe; Timing IS thread-safe and
    rides the pipelined path).
    """
    from ..device import resolve_device
    from ..utils.timing import RECORDER
    from . import align_reads

    if workers > 1 and dots is not None:
        import sys

        print("lra_tpu: -d dotplot collector active -> running batches "
              "sequentially (-t has no effect this run)", file=sys.stderr)
    if workers <= 1 or dots is not None:
        for batch in batches:
            yield align_reads(batch, genome, index, opts,
                              use_device=use_device, genome_li=genome_li,
                              timing=timing, dots=dots, device=device)
        return

    on_cuda = use_device and resolve_device(device).type == "cuda"
    local = threading.local()

    def start_worker():
        if on_cuda:
            import torch

            local.stream = torch.cuda.Stream(device=torch.device(device))

    def run(batch, bid):
        if not on_cuda:
            return align_reads(batch, genome, index, opts,
                               use_device=use_device, genome_li=genome_li,
                               timing=timing, device=device, batch_id=bid)
        import torch

        with torch.cuda.stream(local.stream):
            return align_reads(batch, genome, index, opts,
                               use_device=use_device, genome_li=genome_li,
                               timing=timing, device=device, batch_id=bid)

    with ThreadPoolExecutor(max_workers=workers,
                            initializer=start_worker) as pool:
        pending: deque = deque()
        it = iter(batches)
        exhausted = False
        while True:
            while not exhausted and len(pending) < workers + 1:
                try:
                    batch = next(it)
                except StopIteration:
                    exhausted = True
                    break
                bid = RECORDER.batch_id() if RECORDER.on else None
                pending.append(pool.submit(run, batch, bid))
            if not pending:
                break
            yield pending.popleft().result()
