"""On the card: the -t N stream and the device-round statistics.
align_stream at 4 workers gives the sequential SAM lines with every
kernel launch on a worker's own (non-default) stream; one CudaEventTiming
shared by the workers gives each thread the sequential run's stages;
devstats reads a positive device time for every device round.  Imports
neither jax nor lra_tpu:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_stream_cuda.py -m cuda

Without a CUDA device every test skips."""

import threading

import numpy as np
import pytest
import torch

from lra_tpu_torch import preset
from lra_tpu_torch.index.global_index import build_global_index
from lra_tpu_torch.io.genome import Genome
from lra_tpu_torch.ops import _ext
from lra_tpu_torch.pipeline import align_reads
from lra_tpu_torch.pipeline.stream import align_stream
from lra_tpu_torch.sim import random_genome, sample_read
from lra_tpu_torch.utils import devstats
from lra_tpu_torch.utils.timing import CudaEventTiming

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(21)
    g = random_genome(rng, 300000)
    genome = Genome.from_seqs([("chr1", g)])
    opts = preset("ccs")
    idx = build_global_index(genome, opts)
    reads = [(f"r{i}", sample_read(rng, g, 4000, snp=0.003, ins=0.001,
                                   dele=0.001).codes) for i in range(48)]
    batches = [reads[i:i + 8] for i in range(0, 48, 8)]
    _ext.reset_launches()
    seq = []
    for b in batches:
        seq += align_reads(b, genome, idx, opts, device="cuda")[1]
    torch.cuda.synchronize()
    counts = dict(_ext.LAUNCHES)
    return genome, idx, opts, batches, seq, counts


@pytest.mark.cuda
def test_stream_on_own_streams_matches_sequential(world, monkeypatch):
    genome, idx, opts, batches, seq, counts = world
    streams = []
    lock = threading.Lock()
    launch = _ext.launch

    def spy(*args):
        s = torch.cuda.current_stream()
        with lock:
            streams.append((threading.get_ident(), s.cuda_stream))
        return launch(*args)

    monkeypatch.setattr(_ext, "launch", spy)
    _ext.reset_launches()
    lines = []
    for _, ln in align_stream(batches, genome, idx, opts, workers=4,
                              device="cuda"):
        lines += ln
    assert lines == seq
    assert dict(_ext.LAUNCHES) == counts
    default = torch.cuda.default_stream().cuda_stream
    handles = {h for _, h in streams}
    assert streams and default not in handles
    assert len(handles) >= 2
    by_thread: dict = {}
    for t, h in streams:
        by_thread.setdefault(t, set()).add(h)
    assert all(len(h) == 1 for h in by_thread.values())
    assert len({next(iter(h)) for h in by_thread.values()}) == \
        len(by_thread)


@pytest.mark.cuda
def test_cuda_event_timing_shared_by_workers(world):
    genome, idx, opts, batches, seq, _ = world
    ref = CudaEventTiming()
    align_reads(batches[0], genome, idx, opts, timing=ref, device="cuda")
    want = list(ref.stage_ms())
    tm = CudaEventTiming()
    lines = []
    for _, ln in align_stream(batches, genome, idx, opts, workers=4,
                              timing=tm, device="cuda"):
        lines += ln
    assert lines == seq
    per_thread = tm.thread_stage_ms()
    assert len(per_thread) >= 2
    for st in per_thread.values():
        assert list(st) == want
        assert all(v >= 0.0 for v in st.values())
    assert list(tm.stage_ms()) == want


@pytest.mark.cuda
def test_devstats_device_time(world, monkeypatch):
    genome, idx, opts, batches, seq, _ = world
    monkeypatch.setattr(devstats, "ENABLED", True)
    devstats.reset()
    lines = align_reads(batches[0], genome, idx, opts, device="cuda")[1]
    agg = devstats.report()
    devstats.reset()
    assert lines == seq[:len(lines)]
    assert set(agg) == {"chain_sdp", "refine_boxes", "gap_align",
                        "indel_refine"}
    for tag, a in agg.items():
        assert a["launches"] > 0, tag
        assert a["compute_s"] > 0.0, tag
        assert a["launch_s"] > 0.0 and a["pack_s"] >= a["launch_s"], tag
        assert a["bytes"] > 0, tag
