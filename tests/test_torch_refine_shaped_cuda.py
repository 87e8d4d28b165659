"""On the card: the shaped-band refine kernel (refine_shaped_kernel,
ops/refine_shaped.py) gives the host C DP's blocks (native
refine_dp_shaped) on every region, and its memory is the plane's, the
inputs' and the blocks'.
Imports neither jax nor lra_tpu:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_refine_shaped_cuda.py -m cuda

Without a CUDA device every test skips."""

import numpy as np
import pytest
import torch

from lra_tpu_torch import native
from lra_tpu_torch.ops import refine_shaped as rs
from lra_tpu_torch.sim import shaped_region

M, MM, IND = 4, -3, -4
MB = 1 << 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def windows(q, t, path, k):
    lo, hi = native.refine_windows(path, len(q), len(t), k)
    return q, t, lo, hi


def solve_round(regions, dev, scores=(M, MM, IND)):
    """The kernel's counts of a round's regions, its output, the packed
    round, and how far max_memory_allocated rose."""
    p = rs.pack(regions)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    counts, out = rs.solve(p, *scores, dev)
    counts = counts.cpu().numpy()
    rise = torch.cuda.max_memory_allocated(dev) - base
    return counts, out, p, rise


def blocks_of_round(regions, dev, scores=(M, MM, IND)):
    """The kernel's blocks of a round's regions, its counts, the packed
    round and its memory rise."""
    counts, out, p, rise = solve_round(regions, dev, scores)
    return rs.fetch_blocks(p, counts, out), counts, p, rise


def memory_bound(p) -> float:
    """A round's device memory: its plane (one byte a window cell) and
    10 % more, its blocks' output (12 bytes a block of the caps), plus
    8 MB (the inputs and the counts)."""
    return 1.1 * p.cells + 12 * int(p.caps.sum()) + 8 * MB


def host_blocks(q, t, path, k, scores=(M, MM, IND)):
    return native.refine_dp_shaped(q, t, path, k, *scores)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 50])
def test_random_regions(cuda_device, k):
    """200 regions of 5-60 k rows, 1-3 base indels and gap legs up to 48
    bases, both strands' shapes, in rounds of 25: blocks equal the C
    DP's; each round's memory is its plane and 10 % more, its blocks'
    output, plus 8 MB."""
    rng = np.random.default_rng(1000 + k)
    for rnd in range(8):
        made = [shaped_region(rng, int(rng.integers(5000, 60001)),
                              indel=0.005, snp=0.01, max_indel=3,
                              legs=int(rng.integers(0, 4)), max_leg=48,
                              reverse=bool(r % 2))
                for r in range(25)]
        regions = [windows(q, t, path, k) for q, t, path in made]
        got, counts, p, rise = blocks_of_round(regions, cuda_device)
        assert (counts > 0).all(), counts
        for (q, t, path), bl in zip(made, got):
            np.testing.assert_array_equal(bl, host_blocks(q, t, path, k))
        assert rise <= memory_bound(p), (rise, p.cells)


def region_of_width(rng, width, rows=6000, k=20):
    """A region at k = 20 whose widest window row has `width` cells: one
    insertion leg in its middle, its length searched."""
    q0, t, path0 = shaped_region(rng, rows, indel=0.002, snp=0.01,
                                 max_indel=1)
    mid = len(path0) // 2
    at = int(path0[mid, 0] + path0[mid, 2])
    extra = rng.integers(0, 4, 2 * width).astype(np.int8)
    for g in range(2 * width):
        q = np.concatenate([q0[:at], extra[:g], q0[at:]])
        path = path0.copy()
        path[mid + 1:, 0] += g
        lo, hi = native.refine_windows(path, len(q), len(t), k)
        w = int((hi - lo).max()) + 1
        if w == width:
            return q, t, path, k, lo, hi
        if w > width:
            break
    pytest.fail(f"no region of widest row {width}")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 65, 128, 129, 256, 257, 512])
def test_width_edges(cuda_device, width):
    """A region whose widest row sits at an edge of the warps a block
    (32 cells each) and of the walk's chunk rows (16384 bytes / width, at
    most 256), up to the widest row the kernel takes (512): the C DP's
    blocks."""
    rng = np.random.default_rng(width)
    q, t, path, k, lo, hi = region_of_width(rng, width)
    assert rs.route(len(q), len(t), width, M, MM, IND)
    got, counts, p, _ = blocks_of_round([(q, t, lo, hi)], cuda_device)
    assert p.view("maxw")[0] == width
    np.testing.assert_array_equal(got[0], host_blocks(q, t, path, k))


@pytest.mark.cuda
def test_past_the_widest_row_stays_on_the_host(cuda_device):
    rng = np.random.default_rng(513)
    q, t, path, k, lo, hi = region_of_width(rng, rs.MAX_WIDTH + 1)
    assert not rs.route(len(q), len(t), rs.MAX_WIDTH + 1, M, MM, IND)
    with pytest.raises(ValueError):
        rs.pack([(q, t, lo, hi)])


@pytest.mark.cuda
def test_scores_past_f32_integers(cuda_device):
    """A region whose scores pass 2^24 (m = 64, where f32 rounds the C
    DP's sums): route keeps it on the host, and the kernel, given it
    anyway, gives it up (-2) beside a region it solves, and fetch_blocks
    raises on it."""
    rng = np.random.default_rng(64)
    big = shaped_region(rng, 300_000, indel=0.004, snp=0.001, max_indel=1)
    small = shaped_region(rng, 20_000, indel=0.004, snp=0.001, max_indel=1)
    sc = (64, -3, -4)
    assert not rs.route(len(big[0]), len(big[1]), 120, *sc)
    counts, out, p, _ = solve_round(
        [windows(*big, 50), windows(*small, 50)], cuda_device, scores=sc)
    assert counts[0] == -2 and counts[1] > 0
    with pytest.raises(RuntimeError, match="region 0"):
        rs.fetch_blocks(p, counts, out)
    got, _, _, _ = blocks_of_round([windows(*small, 50)], cuda_device,
                                   scores=sc)
    np.testing.assert_array_equal(got[0], host_blocks(*small, 50, sc))


@pytest.mark.cuda
def test_draft_contig_regions(cuda_device):
    """Every long region of a 2.5 Mb reverse-strand draft contig
    (sim.draft_contig's noise, no SVs) through the pipeline on the card:
    the kernel's blocks equal its twin's over the same windows."""
    from lra_tpu_torch import preset
    from lra_tpu_torch import seq as sequtils
    from lra_tpu_torch.index.global_index import build_global_index
    from lra_tpu_torch.io.genome import Genome
    from lra_tpu_torch.pipeline import align_reads
    from lra_tpu_torch.sim import draft_contig, random_genome

    rng = np.random.default_rng(5)
    g = Genome.from_seqs([("chr1", random_genome(rng, 3_000_000))])
    opts = preset("contig")
    idx = build_global_index(g, opts)
    contig = sequtils.revcomp(draft_contig(rng, g.codes, 100_000, 2_500_000,
                                           dele=0, ins=0))
    seen = []
    orig = rs.pack

    def keep(regions, **kw):
        seen.extend(regions)
        return orig(regions, **kw)

    rs.pack = keep
    try:
        align_reads([("c", contig)], g, idx, opts, device="cuda")
    finally:
        rs.pack = orig
    assert sum(len(r[1]) for r in seen) >= 2_000_000
    got, counts, p, _ = blocks_of_round(seen, cuda_device)
    tc, twin = rs.solve(p, M, MM, IND, "cpu")
    want = rs.fetch_blocks(p, tc.numpy(), twin)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_two_million_rows(cuda_device):
    """One region of 2.1 M rows with a reverse-strand draft contig's
    shape (0.1 % SNPs, 0.4 % one-base insertions and deletions): the C
    DP's blocks, and the round's memory is its plane and 10 % more, its
    blocks' output, plus 8 MB."""
    rng = np.random.default_rng(21)
    q, t, path = shaped_region(rng, 2_100_000, indel=0.004, snp=0.001,
                               max_indel=1, reverse=True)
    got, counts, p, rise = blocks_of_round([windows(q, t, path, 50)],
                                           cuda_device)
    np.testing.assert_array_equal(got[0], host_blocks(q, t, path, 50))
    assert rise <= memory_bound(p), (rise, p.cells)
