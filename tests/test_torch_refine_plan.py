"""K5's launch plan (ops/affine_kernel.refine_plan) and its CPU-side
inputs, without JAX and without a card: every band the wrapper takes
gets a tier whose warps cover it, a plane pitch the traceback can load
as 16-byte vectors, and shared memory a block may use; the edge
problems of sim.refine_problems give the same blocks through the plain
twin as through the host refine DP."""

import numpy as np
import pytest
import torch

from lra_tpu_torch.ops import affine_kernel as ak
from lra_tpu_torch.sim import refine_problems

torch.set_num_threads(2)


@pytest.mark.parametrize("B", [None, 8, 16384])
def test_refine_plan_covers_every_band(B):
    for K in range(1, 1024):
        band = 2 * K + 1
        p = ak.refine_plan(K, B)
        assert p["WP"] * 32 * p["CPT"] >= band, K
        assert p["CPT"] in ak._CPT and 1 <= p["WP"] <= 8, K
        assert p["WP"] == 1 or p["CPT"] == 9, K
        assert p["P"] % 16 == 0 and p["P"] >= band, K
        assert p["P"] == 32 * p["CPT"] * p["WP"], K
        assert p["smem"] <= ak.SMEM_MAX, K
        assert p["threads"] == 32 * p["WP"] * p["PPC"] <= 256, K
        assert p["PPC"] >= 1 and p["R"] >= 1, K


@pytest.mark.parametrize("K,B,cpt,wp,ppc", [
    (30, 16384, 2, 1, 8), (64, 16384, 5, 1, 8), (128, 16384, 9, 1, 8),
    (100, 4096, 9, 1, 8), (256, 4096, 9, 2, 4), (512, 2048, 9, 4, 2),
    (700, 1024, 9, 5, 1), (1023, 1024, 9, 8, 1),
    (30, 8, 2, 1, 1), (64, 512, 5, 1, 1), (128, 1024, 9, 1, 1),
    (256, 64, 9, 2, 1), (512, 8, 9, 4, 1), (1023, 8, 9, 8, 1)])
def test_refine_plan_tiers(K, B, cpt, wp, ppc):
    """The pipeline's K tiers (2 * local_band, 64, 128, 256, 512) and
    off-tier K on a 132-SM card: the fewest warps per problem; 8 warps
    per block when the bucket gives every SM such a block, else one
    problem per block."""
    p = ak.refine_plan(K, B, sms=132)
    assert (p["CPT"], p["WP"], p["PPC"]) == (cpt, wp, ppc)


@pytest.mark.parametrize("B,S,K", [(13, 16, 30), (13, 100, 64),
                                   (9, 160, 100)])
def test_refine_edges_twin_matches_host(B, S, K):
    """The bucket's pad row, qlen or tlen 1, kband 0 and K, kband exactly
    |qlen - tlen|: the twin's packed ops decode to the blocks of the host
    path (banded_refine_np + traceback_refine)."""
    q, t, ql, tl, kb = refine_problems(np.random.default_rng(S + K), B, S, K)
    assert (kb <= K).all() and (np.abs(ql - tl) <= kb).all()
    assert (ql <= S).all() and (tl <= S).all()
    packed = ak.banded_refine_traced_packed(
        *[torch.from_numpy(x) for x in (q, t, ql, tl)], K, 4, -3, -4,
        kband=torch.from_numpy(kb)).numpy()
    got = ak.blocks_from_ops_batch(ak.unpack_ops(packed))
    _, planes = ak.banded_refine_np(q, t, ql, tl, K, 4, -3, -4, kb)
    want = [ak.traceback_refine(planes[b], int(ql[b]), int(tl[b]), K)
            for b in range(B)]
    assert got == want
    assert got[0] == [] and any(len(x) > 1 for x in got)
