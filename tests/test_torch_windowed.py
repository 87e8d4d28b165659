"""K7, the windowed large-N chaining DP, and its host pieces: the port's
plain twin and numpy helpers == lra_tpu's ops/sdp_windowed.py (JAX on
the CPU) on the instances of tests/test_sdp_windowed.py.  Tolerance:
exact everywhere (V compared bit for bit as int32, bp and lane equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_sdp_windowed as tw
from lra_tpu import preset
from lra_tpu.chain import driver as jdriver
from lra_tpu.ops import sdp_windowed as jwin
from lra_tpu.ops.gapcost import from_options
from lra_tpu_torch.chain import driver as tdriver
from lra_tpu_torch.ops import sdp_windowed as twin
from lra_tpu_torch.sim import tie_dense_chain_arrays

torch.set_num_threads(2)


def contig_instance():
    """tests/test_sdp_windowed.py's contig-like geometry (diagonal runs +
    SV jumps), seed 11."""
    rng = np.random.default_rng(11)
    parts = []
    q, t = 0, 5000
    for _ in range(6):
        m = 300
        ln = rng.integers(20, 80, m)
        dq = np.sort(rng.integers(0, 30000, m))
        qS = q + dq
        tS = t + dq + rng.integers(-40, 40, m)
        parts.append((qS, qS + ln, tS, tS + ln))
        q += 31000
        t += 31000 + int(rng.integers(-3000, 60000))
    qS, qE, tS, tE = (np.concatenate([p[k] for p in parts]).astype(np.int64)
                      for k in range(4))
    o = np.argsort(qS, kind="stable")
    qS, qE, tS, tE = qS[o], qE[o], tS[o], tE[o]
    n = len(qS)
    return (qS, qE, tS, tE, (qE - qS).astype(np.float32), np.ones(n, bool),
            np.ones(n, bool))


def repeat_dense_instance(gp):
    """The satellite-decoy cloud of test_adversarial_repeat_dense_density_
    guard, seed 19."""
    rng = np.random.default_rng(19)
    sat = len(gp.table)
    qT = np.arange(400, dtype=np.int64) * 60
    tT = qT + 100
    qD = qT[200] + 1 + rng.integers(0, 58, 1200).astype(np.int64)
    tD = qD + sat + rng.integers(10**6, 2 * 10**6, 1200).astype(np.int64)
    qS = np.concatenate([qT, qD])
    tS = np.concatenate([tT, tD])
    o = np.argsort(qS, kind="stable")
    qS, tS = qS[o], tS[o]
    n = len(qS)
    return (qS, qS + 50, tS, tS + 50,
            np.where(tS > 10**6, 10.0, 120.0).astype(np.float32),
            np.ones(n, bool), np.zeros(n, bool))


def far_sentinel_instance(gp):
    """test_far_sentinel_resolution's two runs across a saturated jump."""
    m = 200
    sat = len(gp.table)
    qS1 = np.arange(m, dtype=np.int64) * 60
    qS2 = qS1 + m * 60 + 1000
    qS = np.concatenate([qS1, qS2])
    tS = np.concatenate([qS1 + 100, qS2 + 100 + sat + 100000])
    return (qS, qS + 50, tS, tS + 50, np.full(2 * m, 120.0, np.float32),
            np.ones(2 * m, bool), np.zeros(2 * m, bool))


def instance(name):
    """(fragments, preset, L, W) of one named instance."""
    if name.startswith("random"):
        n, seed = {"random50": (50, 0), "random180": (180, 1),
                   "random500": (500, 2)}[name]
        rng = np.random.default_rng(seed)
        return (tw.random_instance(rng, n, both_lanes=bool(seed % 2)),
                "ccs", 32, 512)
    if name == "w64":
        return tw.random_instance(np.random.default_rng(7), 600), "ccs", 32, 64
    if name == "contig":
        return contig_instance(), "contig", 32, 256
    if name == "tie_dense":
        inst = tie_dense_chain_arrays(np.random.default_rng(23), 300, 400)
        return inst[:7], "contig", 32, 128
    gp = from_options(preset("contig" if name.startswith("repeat")
                             else "ccs"))
    if name == "repeat_w64":
        return repeat_dense_instance(gp), "contig", 32, 64
    if name == "repeat_guard":
        inst = repeat_dense_instance(gp)
        return inst, "contig", 32, jdriver._windowed_W(inst[0], base=64,
                                                       cap=4096)
    return far_sentinel_instance(gp), "ccs", 32, 64


def kernel_args(inst, L):
    """tests/test_sdp_windowed.py's run_windowed padding, as numpy [1, N]
    arrays (17 of them)."""
    qS, qE, tS, tE, sc, l1, l2 = inst
    n = len(qS)
    N = ((n + L - 1) // L) * L
    valid = np.zeros(N, bool)
    valid[:n] = True

    def pad(a, fill=0, dtype=np.int32):
        out = np.full(N, fill, dtype)
        out[:n] = a
        return out

    s = jwin.far_schedule(qS, qE, tS, tE, l1, l2, np.ones(n, bool), L)
    ins_hi = np.zeros(N // L, np.int32)
    ins_hi[:len(s["ins_hi"])] = s["ins_hi"]
    args = [pad(qS), pad(qE, 2 ** 30), pad(tS), pad(tE),
            pad(sc, 0, np.float32), pad(l1, False, bool),
            pad(l2, False, bool), valid,
            pad(s["perm1"]), pad(s["perm2"]), pad(s["ok1"], False, bool),
            pad(s["ok2"], False, bool), pad(s["qer1"], 2 ** 30),
            pad(s["qer2"], 2 ** 30), pad(s["rank1"]), pad(s["rank2"]),
            ins_hi]
    return [a[None] for a in args]


INSTANCES = ["random50", "random180", "random500", "w64", "contig",
             "repeat_w64", "repeat_guard", "far_sentinel", "tie_dense"]


@pytest.mark.parametrize("name", INSTANCES)
def test_windowed_plain_matches_jax(name):
    inst, pre, L, W = instance(name)
    key = from_options(preset(pre)).static_key()
    args = kernel_args(inst, L)
    want = [np.asarray(x) for x in jwin.chain_scores_windowed(
        *(jnp.asarray(a) for a in args), key, L=L, W=W)]
    got = [x.numpy() for x in twin.chain_scores_windowed(
        *(torch.from_numpy(a) for a in args), key, L=L, W=W)]
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    n = len(inst[0])
    assert (want[1][0, :n] >= 0).any()      # some fragment chains
    if name == "tie_dense":
        # every collector ties: the first index in the window, a far
        # sentinel where the far term ties with nothing near
        assert (want[1] == jwin.FAR1).any()
    if name == "repeat_w64":
        # the far term wins after the decoy cloud: sentinels for the host
        assert (want[1] < -1).any()
        far = np.nonzero(want[1][0, :n] < -1)[0]
        qS, qE, tS, tE, _, l1, l2 = inst
        V = want[0][0, :n]
        for i in far:
            which = 1 if want[1][0, i] == jwin.FAR1 else 2
            ref = jwin.resolve_far_np(int(i), qS, qE, tS, tE, V, l1, l2,
                                      np.ones(n, bool), which, L, W,
                                      N=args[0].shape[1])
            assert twin.resolve_far_np(
                int(i), qS, qE, tS, tE, V, l1, l2, np.ones(n, bool), which,
                L, W, N=args[0].shape[1]) == ref
            assert ref >= 0


@pytest.mark.parametrize("name", INSTANCES)
def test_far_schedule_matches_jax(name):
    inst, _, L, _ = instance(name)
    qS, qE, tS, tE, _, l1, l2 = inst
    valid = np.ones(len(qS), bool)
    want = jwin.far_schedule(qS, qE, tS, tE, l1, l2, valid, L)
    got = twin.far_schedule(qS, qE, tS, tE, l1, l2, valid, L)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_refresh_blocks_and_windowed_W_match_jax():
    for L in (32, 64):
        for W in (64, 256, 512, 4096, 8192, 16384):
            for N in (L, 2 * L, 7 * L, 8192, 16384, 40960, 3 * 8192):
                assert twin._refresh_blocks(L, W, N) == \
                    jwin._refresh_blocks(L, W, N), (L, W, N)
    rng = np.random.default_rng(0)
    cases = [np.array([], np.int64), np.arange(100_000, dtype=np.int64) * 1000,
             np.sort(rng.integers(0, 25_000, 40_000)).astype(np.int64)]
    for span in (2_000, 8_000, 20_000, 60_000):
        cases.append(np.sort(rng.integers(0, 600_000, span)).astype(np.int64))
    for qS in cases:
        for base, cap in ((4096, 16384), (64, 4096)):
            assert tdriver._windowed_W(qS, base, cap) == \
                jdriver._windowed_W(qS, base, cap)
    for name in ("WIN_W", "WIN_L", "WIN_WMAX", "SPLIT_SPAN", "SHARD_N",
                 "SHARD_HALO"):
        assert getattr(tdriver, name) == getattr(jdriver, name), name
    assert (twin.FAR1, twin.FAR2) == (jwin.FAR1, jwin.FAR2)


def test_windowed_cuda_entry_refuses_what_the_kernel_does_not_take():
    """The CUDA entry (no fallback to the twin) checks its inputs before
    it builds or launches anything: L = 64, W a power of two, CUDA
    tensors."""
    inst, pre, _, _ = instance("random50")
    key = from_options(preset(pre)).static_key()
    args = [torch.from_numpy(a) for a in kernel_args(inst, 64)]
    with pytest.raises(ValueError, match="L=64"):
        twin._chain_scores_windowed_cuda(*args, key, 32, 4096)
    with pytest.raises(ValueError, match="power of two"):
        twin._chain_scores_windowed_cuda(*args, key, 64, 3000)
    with pytest.raises(ValueError, match="CUDA"):
        twin._chain_scores_windowed_cuda(*args, key, 64, 4096)
