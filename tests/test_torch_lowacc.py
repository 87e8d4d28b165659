"""The ONT / CLR pipeline end to end: lra_tpu_torch on device="cpu"
(every kernel's plain torch twin) gives SAM lines byte-equal to
lra_tpu.pipeline.align_reads on tests/test_lowacc.py's genome shape, in
the device path and in the host path.  Tolerance: exact (byte-equal SAM
lines)."""

import numpy as np
import pytest
import torch

from lra_tpu import preset
from lra_tpu.index.global_index import build_global_index
from lra_tpu.index.local_index import build_genome_local_index
from lra_tpu.io.genome import Genome
from lra_tpu.pipeline import align_reads
from lra_tpu.sim import random_genome, sample_read
from lra_tpu_torch import preset as t_preset
from lra_tpu_torch.index.global_index import index_from_arrays
from lra_tpu_torch.index.local_index import \
    build_genome_local_index as t_build_genome_local_index
from lra_tpu_torch.io.genome import Genome as TGenome
from lra_tpu_torch.pipeline import align_reads as t_align_reads

torch.set_num_threads(2)

FIELDS = ("tuples", "pos", "strand", "freqs")
# bench.py's error split: 60 % substitutions, 20 % insertions, 20 %
# deletions of the preset's error rate (ONT 5 %, CLR 12 %).  The read
# seeds keep the indel-refine buckets small: lra_tpu's scans on JAX-CPU
# dominate this file's time.
ERR = {"ont": 0.05, "clr": 0.12}
SEED = {"ont": 9, "clr": 10}


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(17)
    seqs = [("chr1", random_genome(rng, 150000))]
    return seqs, Genome.from_seqs(seqs)


@pytest.fixture(scope="module", params=["ont", "clr"])
def world(request, genome):
    kind = request.param
    seqs, g = genome
    opts = preset(kind)
    idx = build_global_index(g, opts)
    gli = build_genome_local_index(g, max_freq=opts.local_max_freq)
    rng = np.random.default_rng(SEED[kind])
    err = ERR[kind]
    reads = [(f"{kind}{i}", sample_read(rng, g.codes, 6000, snp=0.6 * err,
                                        ins=0.2 * err, dele=0.2 * err,
                                        rev_prob=0.5).codes)
             for i in range(2)]
    return kind, seqs, g, opts, idx, gli, reads


@pytest.mark.parametrize("use_device", [True, False])
def test_sam_lines_equal_jax(world, use_device):
    kind, seqs, g, opts, idx, gli, reads = world
    tg = TGenome.from_seqs(seqs)
    topts = t_preset(kind)
    tidx = index_from_arrays(k=idx.k, **{f: getattr(idx, f)
                                         for f in FIELDS})
    tgli = t_build_genome_local_index(tg, max_freq=topts.local_max_freq)
    _, want = align_reads(reads, g, idx, opts, use_device=use_device,
                          genome_li=gli)
    _, got = t_align_reads(reads, tg, tidx, topts, use_device=use_device,
                           genome_li=tgli, device="cpu")
    assert len(want) >= len(reads)
    assert sum(1 for ln in want if ln.split("\t")[2] != "*") >= 2
    assert got == want
