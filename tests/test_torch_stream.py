"""The -t N stream of lra_tpu_torch: align_stream gives the port's own
sequential align_reads lines, in order, at any worker count and batch
partition (tests/test_torch_e2e.py pins the sequential lines to
lra_tpu's); the launch counts of ops/_ext.py and CudaEventTiming's
stages stay exact when several threads launch at once.  On the CPU the
device rounds run the kernels' plain torch twins (device="cpu").
Tolerance: exact."""

import sys
import threading

import numpy as np
import pytest
import torch

from lra_tpu_torch import preset
from lra_tpu_torch.index.global_index import build_global_index
from lra_tpu_torch.io.genome import Genome
from lra_tpu_torch.pipeline import align_reads
from lra_tpu_torch.pipeline.stream import align_stream
from lra_tpu_torch.sim import random_genome, sample_read

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(21)
    g = random_genome(rng, 120000)
    genome = Genome.from_seqs([("chr1", g)])
    opts = preset("ccs")
    idx = build_global_index(genome, opts)
    reads = [(f"r{i}", sample_read(rng, g, 3000, snp=0.003).codes)
             for i in range(12)]
    seq_lines = {True: [], False: []}
    for use_device in (True, False):
        for b in (reads[0:4], reads[4:8], reads[8:12]):
            _, lines = align_reads(b, genome, idx, opts,
                                   use_device=use_device, device="cpu")
            seq_lines[use_device].extend(lines)
    return genome, idx, opts, reads, seq_lines


@pytest.mark.parametrize("workers", [2, 4])
def test_stream_matches_sequential(world, workers):
    genome, idx, opts, reads, seq_lines = world
    batches = [reads[0:4], reads[4:8], reads[8:12]]
    par_lines = []
    for _, lines in align_stream(batches, genome, idx, opts,
                                 use_device=True, workers=workers,
                                 device="cpu"):
        par_lines.extend(lines)
    assert par_lines == seq_lines[True]


def test_stream_race_stress(world):
    """Randomized partitions x worker counts, many seeds: output must be
    bit-identical to sequential every time (the tsan-toggle analog).  On
    the host path (use_device=False), which shares every host stage with
    the device path at a fraction of the plain twins' CPU time."""
    genome, idx, opts, reads, seq_lines = world
    for seed in range(20):
        rng = np.random.default_rng(100 + seed)
        cuts = sorted(rng.choice(np.arange(1, len(reads)),
                                 size=int(rng.integers(1, 5)),
                                 replace=False).tolist())
        bounds = [0] + cuts + [len(reads)]
        batches = [reads[bounds[i]:bounds[i + 1]]
                   for i in range(len(bounds) - 1)]
        workers = int(rng.integers(2, 5))
        par_lines = []
        for _, lines in align_stream(batches, genome, idx, opts,
                                     use_device=False, workers=workers,
                                     device="cpu"):
            par_lines.extend(lines)
        assert par_lines == seq_lines[False], \
            f"seed {seed}: batches {bounds} workers {workers}"


def test_stream_timing_pipelined(world):
    """Timing is thread-safe: --timing does not force sequential mode,
    and the pipelined run records every stage with sane totals (host
    path: the stages and their ticks are the device path's)."""
    from lra_tpu_torch.utils.timing import Timing

    genome, idx, opts, reads, seq_lines = world
    batches = [reads[0:4], reads[4:8], reads[8:12]]
    tm = Timing()
    par_lines = []
    for _, lines in align_stream(batches, genome, idx, opts,
                                 use_device=False, workers=3, timing=tm,
                                 device="cpu"):
        par_lines.extend(lines)
    assert par_lines == seq_lines[False]
    assert tm.counts.get("gap-align (device)", 0) == len(batches)
    assert all(v >= 0.0 for v in tm.totals.values())


def test_stream_empty_and_single():
    """align_stream over zero batches and a single batch."""
    rng = np.random.default_rng(3)
    g = random_genome(rng, 50000)
    genome = Genome.from_seqs([("chr1", g)])
    opts = preset("ccs")
    idx = build_global_index(genome, opts)
    assert list(align_stream([], genome, idx, opts, workers=2,
                             device="cpu")) == []
    reads = [("r0", sample_read(rng, g, 2000, snp=0.003).codes)]
    out = list(align_stream([reads], genome, idx, opts, workers=2,
                            device="cpu"))
    assert len(out) == 1 and len(out[0][1]) >= 1


def test_stream_with_dots_runs_sequentially(world, tmp_path, capfd):
    """A dot collector forces the sequential path, with lra_tpu's note."""
    from lra_tpu_torch.utils.dots import DotDumper

    genome, idx, opts, reads, seq_lines = world
    dots = {"r1": DotDumper(str(tmp_path), "r1")}
    out = []
    for _, lines in align_stream([reads[0:4]], genome, idx, opts,
                                 use_device=False, dots=dots, workers=4,
                                 device="cpu"):
        out.extend(lines)
    assert out == seq_lines[False][:len(out)]
    assert "running batches sequentially" in capfd.readouterr().err
    assert (tmp_path / "all-matches.dots").exists()


class _FakeStream:
    cuda_stream = 0


def test_launch_counts_exact_across_threads(monkeypatch):
    """8 threads x 1000 launches through ops/_ext.launch (the C entry
    point and the stream handle stubbed), with the interpreter switching
    threads every microsecond and the counts' dict yielding to another
    thread inside each read-modify-write: the count is exact."""
    import time

    from lra_tpu_torch.ops import _ext

    class Yielding(dict):
        def __getitem__(self, k):
            v = super().__getitem__(k)
            time.sleep(0)
            return v

    monkeypatch.setattr(_ext, "_entry", lambda lib, fn, argtypes:
                        (lambda *args: 0))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _FakeStream)
    monkeypatch.setattr(_ext, "LAUNCHES", Yielding(_ext.LAUNCHES))
    _ext.reset_launches()
    start = threading.Barrier(8)

    def run():
        start.wait()
        for _ in range(1000):
            _ext.launch("one_gap_traced", "one_gap", "f", [])

    threads = [threading.Thread(target=run) for _ in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert _ext.LAUNCHES["one_gap_traced"] == 8000
    _ext.reset_launches()
    assert not any(_ext.LAUNCHES.values())


def test_entry_points_made_once_across_threads(monkeypatch):
    """_entry looks up and types a C entry point once, whichever of 8
    threads asks first; every thread gets that one function."""
    import ctypes

    from lra_tpu_torch.ops import _ext

    made = []

    class Lib:
        def __getattr__(self, name):
            made.append(name)
            return type("Fn", (), {})()

    monkeypatch.setattr(_ext, "_lib", lambda name: Lib())
    monkeypatch.setattr(_ext, "_entries", {})
    start = threading.Barrier(8)
    got = []

    def run():
        start.wait()
        got.append(_ext._entry("x", "lra_fn", [ctypes.c_int]))

    threads = [threading.Thread(target=run) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert made == ["lra_fn"]
    assert len({id(f) for f in got}) == 1
    assert got[0].argtypes == [ctypes.c_int, ctypes.c_void_p]


class _FakeEvent:
    """A CUDA event stand-in: record() stamps a per-thread clock, so a
    stage read across two threads' events would come out wrong."""

    clock = threading.local()

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        c = getattr(self.clock, "t", 0) + 1
        self.clock.t = c
        self.t = (threading.get_ident(), c)

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        assert self.t[0] == other.t[0], "events of two threads paired"
        return float(other.t[1] - self.t[1])


def test_cuda_event_timing_shared_by_threads(monkeypatch):
    """One CudaEventTiming shared by 4 threads, each running 3 batches:
    every stage pairs two events of one batch on one thread, so each
    thread's stages are exactly its own ticks (1 unit each, per batch)."""
    from lra_tpu_torch.utils.timing import CudaEventTiming

    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    tm = CudaEventTiming()
    labels = ["anchors", "SDP-1 (device)", "gap-align (device)"]
    start = threading.Barrier(4)

    def run():
        start.wait()
        for _ in range(3):
            tm.start()
            for label in labels:
                tm.tick(label)

    threads = [threading.Thread(target=run, name=f"w{i}")
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    per_thread = tm.thread_stage_ms()
    assert sorted(per_thread) == ["w0", "w1", "w2", "w3"]
    for st in per_thread.values():
        assert list(st) == labels
        assert all(v == 3.0 for v in st.values())
    assert tm.stage_ms() == {label: 12.0 for label in labels}
    assert tm.counts == {label: 12 for label in labels}
