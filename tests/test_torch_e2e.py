"""The CCS pipeline end to end: lra_tpu_torch on device="cpu" (every
kernel's plain torch twin) gives SAM lines byte-equal to
lra_tpu.pipeline.align_reads on tests/test_e2e.py's world, in the host
path, the device path, and the device path with the row-sync kernel.
Tolerance: exact (byte-equal SAM lines)."""

import numpy as np
import pytest
import torch

from lra_tpu import preset
from lra_tpu.index.global_index import build_global_index
from lra_tpu.io.genome import Genome
from lra_tpu.pipeline import align_reads
from lra_tpu.sim import random_genome, sample_read
from lra_tpu_torch import preset as t_preset
from lra_tpu_torch.index.global_index import \
    build_global_index as t_build_global_index
from lra_tpu_torch.index.global_index import index_from_arrays
from lra_tpu_torch.io.genome import Genome as TGenome
from lra_tpu_torch.pipeline import align_reads as t_align_reads

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(42)
    seqs = [("chr1", random_genome(rng, 150000)),
            ("chr2", random_genome(rng, 100000))]
    g = Genome.from_seqs(seqs)
    idx = build_global_index(g, preset("ccs"))
    reads = []
    for seed in (1, 2):
        r2 = np.random.default_rng(seed)
        for i in range(3):
            r = sample_read(r2, g.codes, 4000, snp=0.003, ins=0.001,
                            dele=0.001)
            reads.append((f"s{seed}r{i}", r.codes))
    return seqs, g, idx, reads


FIELDS = ("tuples", "pos", "strand", "freqs")


def test_port_index_build_equals_jax(world):
    seqs, _, idx, _ = world
    own = t_build_global_index(TGenome.from_seqs(seqs), t_preset("ccs"))
    assert own.k == idx.k
    for f in FIELDS:
        a, b = getattr(own, f), getattr(idx, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_device,use_pallas", [(True, False),
                                                   (True, True),
                                                   (False, False)])
def test_sam_lines_equal_jax(world, use_device, use_pallas):
    """use_pallas=True: lra_tpu runs banded_global_traced_packed off the
    TPU, the port the row-sync twin — the two must agree."""
    seqs, g, idx, reads = world
    opts = preset("ccs")
    opts.use_pallas = use_pallas
    topts = t_preset("ccs")
    topts.use_pallas = use_pallas
    tidx = index_from_arrays(k=idx.k, **{f: getattr(idx, f)
                                         for f in FIELDS})
    _, want = align_reads(reads, g, idx, opts, use_device=use_device)
    _, got = t_align_reads(reads, TGenome.from_seqs(seqs), tidx, topts,
                           use_device=use_device, device="cpu")
    assert len(want) >= len(reads)
    assert sum(1 for ln in want if ln.split("\t")[2] != "*") >= 5
    assert got == want
