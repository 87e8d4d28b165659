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
from lra_tpu_torch.sim import (contig_chain_arrays, mask_problems,
                               tie_dense_chain_arrays)

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


def tie_batch(rng, B, N):
    """Tie-dense problems (sim.tie_dense_chain_arrays: roots at one q,
    collectors tying across every root in both lanes) at the driver's
    padding."""
    plist = [tdriver.ChainProblem(*tie_dense_chain_arrays(
        rng, int(rng.integers(2, N // 4 + 2)),
        int(rng.integers(2, N // 2 + 1)))) for _ in range(B)]
    return tdriver.pad_problems(plist, B, N)


# seed "tie": the tie-dense instance, which pins the first-index and lane
# tie rules against lra_tpu itself
@pytest.mark.parametrize("B,N,seed", [(4, 64, 0), (3, 128, 1),
                                      (2, 128, "tie")])
def test_chain_scores_blocked_and_mask_plain_match_jax(key, B, N, seed):
    if seed == "tie":
        rng = np.random.default_rng(7)
        args = tie_batch(rng, B, N)
    else:
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


def test_chain_mask_plain_matches_jax_edges():
    """K3's edge problems (sim.mask_problems: no valid row, vmax < 0,
    vmax = 0, ties for vmax, a chain of all N rows): the plain twin's
    vmax and bit words == lra_tpu's."""
    V, bp, valid = mask_problems(np.random.default_rng(4), 6, 64)
    vmax, bits = [np.asarray(x) for x in jsdp.chain_mask_from_scores(
        jnp.asarray(V), jnp.asarray(bp), jnp.asarray(valid))]
    tvmax, tbits = [x.numpy() for x in tsdp.chain_mask_from_scores(
        *(torch.from_numpy(a) for a in (V, bp, valid)))]
    np.testing.assert_array_equal(tvmax.view(np.int32), vmax.view(np.int32))
    np.testing.assert_array_equal(tbits, bits)
    assert (bits[:3] == 0).all() and (bits[4] == -1).all()


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


def big_problems(mod, seed, sizes):
    """Contig-like problems (lra_tpu_torch.sim.contig_chain_arrays) as
    ChainProblems of the driver module `mod`."""
    return [mod.ChainProblem(*contig_chain_arrays(
        np.random.default_rng(1000 * seed + i), n))
        for i, n in enumerate(sizes)]


@pytest.mark.parametrize("case,use_device", [
    ("windowed", True), ("sharded", True), ("sharded", False),
    ("sharded_mixed", False)])
def test_solve_problems_beyond_8192_matches_jax(monkeypatch, case,
                                                use_device):
    """Problems past the top bucket and past SHARD_N.  "windowed": one
    problem of 8193 fragments, the windowed kernel at N = 16384.
    "sharded": ~10k fragments with SHARD_N cut to 4096 in both drivers
    (and the buckets to (64,), so the shards' children run on the
    windowed kernel too).  On the host path the numpy oracle is O(n^2)
    per problem, so its cases shard 600 fragments at SHARD_N = 200
    (beside a normal problem in round 0 for "sharded_mixed").  V, bp and
    lane equal field by field."""
    gp = from_options(preset("ccs"))
    if case == "windowed":
        sizes = [8193]
    elif use_device:
        sizes = [10000]
        for mod in (jdriver, tdriver):
            monkeypatch.setattr(mod, "SHARD_N", 4096)
            monkeypatch.setattr(mod, "_BUCKETS", (64,))
    else:
        sizes = [600] if case == "sharded" else [40, 600]
        for mod in (jdriver, tdriver):
            monkeypatch.setattr(mod, "SHARD_N", 200)
    jp = big_problems(jdriver, 7, sizes)
    tp = big_problems(tdriver, 7, sizes)
    seen = []
    orig = tdriver._solve_batch

    def record(problems, *a):
        seen.append([len(p.qS) for p in problems])
        return orig(problems, *a)

    monkeypatch.setattr(tdriver, "_solve_batch", record)
    jdriver.solve_problems(jp, gp, use_device=use_device)
    tdriver.solve_problems(tp, gp, use_device=use_device, device="cpu")
    if case == "windowed":
        assert seen == [[8193]]
    else:
        assert len(seen) >= 3           # sequential shard rounds
    for a, b in zip(jp, tp):
        for f in ("V", "bp", "lane"):
            np.testing.assert_array_equal(np.asarray(getattr(b, f)),
                                          np.asarray(getattr(a, f)), f)
        assert b.win_W == a.win_W
        assert len(a.qS) < 100 or (a.bp >= 0).sum() > len(a.qS) // 2
        assert tdriver.best_chain(b) == jdriver.best_chain(a)
