"""K2/K3 and the chain driver: the port's plain twins and solve_problems
== lra_tpu's on the same numpy inputs.  Tolerance: exact everywhere (V
compared bit for bit as f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lra_tpu import preset
from lra_tpu.chain import driver as jdriver
from lra_tpu.ops import sdp_blocked as jsdp
from lra_tpu.ops.gapcost import from_options
from lra_tpu_torch.chain import driver as tdriver
from lra_tpu_torch.ops import sdp_blocked as tsdp

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def key():
    return from_options(preset("ccs")).static_key()


def frag_batch(rng, B, N, nvalid):
    ln = rng.integers(15, 60, (B, N))
    qS = np.sort(rng.integers(0, 60 * N, (B, N)), axis=1)
    tS = (qS + rng.integers(-1500, 1500, (B, N))).clip(0)
    strand = rng.random((B, N)) < 0.7
    both = rng.random((B, N)) < 0.2
    valid = np.zeros((B, N), bool)
    for b in range(B):
        valid[b, :nvalid[b]] = True
    return [qS.astype(np.int32), (qS + ln).astype(np.int32),
            tS.astype(np.int32), (tS + ln).astype(np.int32),
            (ln * 2.0).astype(np.float32), strand | both, ~strand | both,
            valid]


@pytest.mark.parametrize("B,N,seed", [(4, 64, 0), (3, 128, 1)])
def test_chain_scores_blocked_and_mask_plain_match_jax(key, B, N, seed):
    rng = np.random.default_rng(seed)
    args = frag_batch(rng, B, N, rng.integers(N // 2, N + 1, B))
    V, bp, lane = [np.asarray(x) for x in jsdp.chain_scores_blocked(
        *(jnp.asarray(a) for a in args), key)]
    tV, tbp, tlane = [x.numpy() for x in tsdp.chain_scores_blocked(
        *(torch.from_numpy(a) for a in args), key)]
    np.testing.assert_array_equal(tV.view(np.int32), V.view(np.int32))
    np.testing.assert_array_equal(tbp, bp)
    np.testing.assert_array_equal(tlane, lane)
    assert (bp >= 0).sum() > B and (lane == 2).any()

    vmax, bits = [np.asarray(x) for x in jsdp.chain_mask_from_scores(
        jnp.asarray(V), jnp.asarray(bp), jnp.asarray(args[7]))]
    tvmax, tbits = [x.numpy() for x in tsdp.chain_mask_from_scores(
        torch.from_numpy(tV), torch.from_numpy(tbp),
        torch.from_numpy(args[7]))]
    np.testing.assert_array_equal(tvmax.view(np.int32), vmax.view(np.int32))
    np.testing.assert_array_equal(tbits, bits)


def rand_problems(mod, seed, sizes, need_full):
    out = []
    for i, n in enumerate(sizes):
        rng = np.random.default_rng(1000 * seed + i)
        ln = rng.integers(15, 60, n)
        qS = np.sort(rng.integers(0, 50000, n)).astype(np.int64)
        tS = (qS + rng.integers(-1500, 1500, n)).clip(0).astype(np.int64)
        strand = rng.random(n) < 0.8
        out.append(mod.ChainProblem(
            qS, qS + ln, tS, tS + ln, ln.astype(np.float32) * 2.0, strand,
            ~strand, np.arange(n, dtype=np.int64), 0, need_full=need_full))
    return out


@pytest.mark.parametrize("use_device", [True, False])
def test_solve_problems_matches_jax(use_device):
    gp = from_options(preset("ccs"))
    sizes = [1, 5, 40, 64, 65, 120]
    for need_full in (True, False):
        jp = rand_problems(jdriver, 3, sizes, need_full)
        tp = rand_problems(tdriver, 3, sizes, need_full)
        jdriver.solve_problems(jp, gp, use_device=use_device)
        tdriver.solve_problems(tp, gp, use_device=use_device, device="cpu")
        for a, b in zip(jp, tp):
            for f in ("V", "bp", "lane", "chain_rows"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None), f
                if x is not None:
                    np.testing.assert_array_equal(np.asarray(y),
                                                  np.asarray(x))
            assert np.float32(b.vmax).tobytes() == \
                np.float32(a.vmax).tobytes()
            assert tdriver.best_chain(b) == jdriver.best_chain(a)
            assert tdriver.chain_vmax(b) == jdriver.chain_vmax(a)


def test_solve_problems_beyond_8192_fragments_not_ported():
    gp = from_options(preset("ccs"))
    (p,) = rand_problems(tdriver, 7, [8193], True)
    with pytest.raises(NotImplementedError, match="CONTIG"):
        tdriver.solve_problems([p], gp, use_device=True, device="cpu")
