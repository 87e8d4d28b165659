"""Degenerate inputs on lra_tpu_torch: no crash, sensible outcomes
(tests/test_degenerate.py's cases and assertions, on the port alone: the
host path and the device path on device="cpu").  No JAX."""

import numpy as np
import pytest
import torch

from lra_tpu_torch import preset
from lra_tpu_torch.index.global_index import build_global_index
from lra_tpu_torch.io.genome import Genome
from lra_tpu_torch.pipeline import align_reads
from lra_tpu_torch.sim import random_genome

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    g = Genome.from_seqs([("c1", random_genome(rng, 50000)),
                          ("c2", random_genome(rng, 30000))])
    opts = preset("ccs")
    idx = build_global_index(g, opts)
    return g, opts, idx


@pytest.mark.parametrize("use_device", [False, True])
@pytest.mark.parametrize("name,mk", [
    ("all_N", lambda g: np.full(5000, 4, np.uint8)),
    ("tiny", lambda g: np.array(g.codes[100:120])),
    ("shorter_than_k", lambda g: np.array(g.codes[100:110])),
    ("empty", lambda g: np.zeros(0, np.uint8)),
    ("homopolymer", lambda g: np.zeros(3000, np.uint8)),
    ("n_runs", lambda g: np.concatenate([
        g.codes[1000:2000], np.full(500, 4, np.uint8), g.codes[2500:3500]])),
])
def test_no_crash(world, name, mk, use_device):
    g, opts, idx = world
    states, lines = align_reads([(name, mk(g))], g, idx, opts,
                                use_device=use_device, device="cpu")
    assert len(lines) >= 1        # mapped or an unmapped record


@pytest.mark.parametrize("use_device", [False, True])
def test_cross_chromosome_boundary_read(world, use_device):
    """A read contiguous across the c1/c2 junction of the concatenated
    coordinate space splits into per-chromosome segments."""
    g, opts, idx = world
    codes = np.array(g.codes[48000:52000])
    states, _ = align_reads([("xb", codes)], g, idx, opts,
                            use_device=use_device, device="cpu")
    st = states[0]
    assert not st.unaligned
    chroms = {sg.chrom for gr in st.groups for sg in gr.segments}
    assert chroms == {0, 1}


@pytest.mark.parametrize("use_device", [False, True])
def test_empty_genome(world, use_device):
    _, opts, _ = world
    ge = Genome.from_seqs([("e", np.zeros(0, np.uint8))])
    idxe = build_global_index(ge, opts)
    g, _, _ = world
    states, lines = align_reads([("r", np.array(g.codes[100:2000]))],
                                ge, idxe, opts, use_device=use_device,
                                device="cpu")
    assert states[0].unaligned
