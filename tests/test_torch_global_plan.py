"""K4's launch plan (ops/affine_kernel.global_plan) and its CPU-side
inputs, without JAX and without a card: every band the wrapper takes
gets a tier whose warps cover it, a plane pitch that holds two bits a
cell and that the traceback can load as 16-byte vectors, and shared
memory a block may use; the edge problems of sim.refine_problems give
the same blocks through the plain twin as through the host path."""

import numpy as np
import pytest
import torch

from lra_tpu_torch.ops import affine_kernel as ak
from lra_tpu_torch.sim import refine_problems

torch.set_num_threads(2)


@pytest.mark.parametrize("B", [None, 8, 65536])
def test_global_plan_covers_every_band(B):
    for K in range(1, 1024):
        band = 2 * K + 1
        p = ak.global_plan(K, B)
        assert p["WP"] * 32 * p["CPT"] >= band, K
        assert p["CPT"] in ak._CPT and 1 <= p["WP"] <= 8, K
        assert p["WP"] == 1 or p["CPT"] == 9, K
        assert p["P"] == 16 * ((p["CPT"] + 1) // 2) * p["WP"], K
        assert p["P"] % 16 == 0 and 4 * p["P"] >= band, K
        assert 16 <= p["R"] <= 64, K
        assert p["smem"] <= ak.SMEM_MAX, K
        assert p["threads"] == 32 * p["WP"] * p["PPC"] <= 256, K
        assert p["PPC"] >= 1, K
        assert (p["CPT"], p["WP"], p["PPC"]) == tuple(
            ak.refine_plan(K, B)[k] for k in ("CPT", "WP", "PPC")), K


@pytest.mark.parametrize("K,B,cpt,wp,ppc,P", [
    (30, 65536, 2, 1, 8, 16), (64, 4096, 5, 1, 8, 48),
    (128, 2048, 9, 1, 8, 80), (100, 1056, 9, 1, 8, 80),
    (256, 1024, 9, 2, 4, 160), (512, 512, 9, 4, 2, 320),
    (700, 1024, 9, 5, 1, 400), (1023, 256, 9, 8, 1, 640),
    (30, 1055, 2, 1, 1, 16), (64, 8, 5, 1, 1, 48), (128, 1024, 9, 1, 1, 80),
    (256, 64, 9, 2, 1, 160), (512, 8, 9, 4, 1, 320),
    (1023, 8, 9, 8, 1, 640)])
def test_global_plan_tiers(K, B, cpt, wp, ppc, P):
    """The pipeline's K tiers (2 * local_band, 64, 128, 256, 512) and
    off-tier K on a 132-SM card: the fewest warps per problem; 8 warps
    per block when the bucket gives every SM such a block, else one
    problem per block; 16 bytes of ballot words a warp per two cells of
    a lane."""
    p = ak.global_plan(K, B, sms=132)
    assert (p["CPT"], p["WP"], p["PPC"], p["P"]) == (cpt, wp, ppc, P)


@pytest.mark.parametrize("B,S,K", [(13, 16, 30), (13, 64, 30),
                                   (13, 100, 64), (9, 160, 100),
                                   (7, 96, 256)])
def test_global_edges_twin_matches_host(B, S, K):
    """The bucket's pad row, qlen or tlen 1, kband 0 and K, kband exactly
    |qlen - tlen|: the K4 twin's packed ops decode to the blocks of the
    host path (banded_global_np + traceback_banded)."""
    q, t, ql, tl, kb = refine_problems(np.random.default_rng(S + K), B, S, K)
    assert (kb <= K).all() and (np.abs(ql - tl) <= kb).all()
    packed = ak.banded_global_traced_packed(
        *[torch.from_numpy(x) for x in (q, t, ql, tl)], K, 4, -3, -4,
        kband=torch.from_numpy(kb)).numpy()
    got = ak.blocks_from_ops_batch(ak.unpack_ops(packed))
    _, arrows = ak.banded_global_np(q, t, ql, tl, K, 4, -3, -4, kb)
    want = [ak.traceback_banded(arrows[b], int(ql[b]), int(tl[b]), K)[0]
            for b in range(B)]
    assert got == want
    assert got[0] == [] and any(len(x) > 1 for x in got)
