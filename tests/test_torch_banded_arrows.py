"""K9, the banded global DP with its full arrow plane: the port's
banded_global_kernel (plain twin on CPU tensors) and
banded_global_traced == lra_tpu's ops/affine_kernel.py functions of the
same names on the same numpy inputs.  Tolerance: exact (scores bit for
bit, arrows and ops equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lra_tpu.ops import affine_kernel as jak
from lra_tpu_torch.ops import affine_kernel as tak

torch.set_num_threads(2)
M, MM, IND = 4, -3, -4


def bucket(rng, B, Q, T, K, lo, hi):
    t = rng.integers(0, 4, (B, T)).astype(np.int8)
    q = np.zeros((B, Q), np.int8)
    q[:, :min(Q, T)] = t[:, :min(Q, T)]
    flip = rng.random((B, Q)) < 0.05
    q[flip] = (q[flip] + 1) % 4
    tlen = rng.integers(lo, hi + 1, B).astype(np.int32)
    qlen = np.clip(tlen + rng.integers(-K, K + 1, B), lo, min(hi, Q)) \
        .astype(np.int32)
    kband = np.minimum(np.abs(qlen - tlen) + rng.integers(0, 6, B),
                       K).astype(np.int32)
    return q, t, qlen, tlen, kband


def jax_call(fn, q, t, qlen, tlen, K, kband):
    kw = {} if kband is None else {"kband": jnp.asarray(kband)}
    return fn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qlen),
              jnp.asarray(tlen), K, M, MM, IND, **kw)


def torch_call(fn, q, t, qlen, tlen, K, kband):
    kb = None if kband is None else torch.from_numpy(kband)
    return fn(torch.from_numpy(q), torch.from_numpy(t),
              torch.from_numpy(qlen), torch.from_numpy(tlen), K, M, MM,
              IND, kband=kb)


def assert_same(got, want):
    gs, ga = got
    ws, wa = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gs.numpy().view(np.int32),
                                  ws.view(np.int32))
    np.testing.assert_array_equal(ga.numpy(), wa)


@pytest.mark.parametrize("per_problem", [False, True])
def test_banded_global_kernel_matches_jax(per_problem):
    rng = np.random.default_rng(3)
    K = 10
    q, t, qlen, tlen, kband = bucket(rng, 16, 120, 120, K, 30, 120)
    kb = kband if per_problem else None
    want = jax_call(jak.banded_global_kernel, q, t, qlen, tlen, K, kb)
    got = torch_call(tak.banded_global_kernel, q, t, qlen, tlen, K, kb)
    assert got[1].shape == (16, 121, 2 * K + 1)
    assert_same(got, want)


@pytest.mark.parametrize("qlen,tlen,band_cell", [(20, 10, 8), (3, 15, 1)])
def test_banded_global_kernel_score_edge(qlen, tlen, band_cell):
    """|qlen - tlen| > K: the score cell qlen - tlen + K lies outside the
    band.  lra_tpu's gather wraps a negative index once and clamps, so
    (20, 10) at K=4 reads d = 14 -> 8, a real cell (banded_global_np
    raises there), and (3, 15) reads d = -8 -> 1, where the row is
    unreachable (numpy wraps the same way)."""
    K = 4
    rng = np.random.default_rng(qlen)
    q = rng.integers(0, 4, (1, 24)).astype(np.int8)
    t = rng.integers(0, 4, (1, 24)).astype(np.int8)
    ql, tl = np.array([qlen], np.int32), np.array([tlen], np.int32)
    want = jax_call(jak.banded_global_kernel, q, t, ql, tl, K, None)
    got = torch_call(tak.banded_global_kernel, q, t, ql, tl, K, None)
    assert_same(got, want)
    score, _ = tak.banded_arrows_plain(
        *[torch.from_numpy(a) for a in (q, t, ql, tl)], K, M, MM, IND,
        torch.tensor([K], dtype=torch.int32), with_score=True)
    assert score[0] == got[0][0]
    if qlen > tlen:
        assert float(got[0][0]) > -1e29      # a reachable cell
    else:
        assert float(got[0][0]) == np.float32(-1e30)
    assert int(tak._gather_index(torch.tensor(qlen - tlen + K),
                                 2 * K + 1)) == band_cell
    host = (q, t, ql, tl, K, M, MM, IND, np.array([K], np.int32))
    if qlen > tlen:
        with pytest.raises(IndexError):
            tak.banded_global_np(*host)
    else:
        assert tak.banded_global_np(*host)[0][0] == got[0][0]


def test_banded_global_kernel_empty_sides():
    """qlen or tlen 0: only row 0 (or column 0) is reachable."""
    K = 10
    rng = np.random.default_rng(5)
    q = rng.integers(0, 4, (4, 16)).astype(np.int8)
    t = rng.integers(0, 4, (4, 16)).astype(np.int8)
    qlen = np.array([0, 10, 0, 5], np.int32)
    tlen = np.array([10, 0, 0, 5], np.int32)
    want = jax_call(jak.banded_global_kernel, q, t, qlen, tlen, K, None)
    got = torch_call(tak.banded_global_kernel, q, t, qlen, tlen, K, None)
    assert_same(got, want)
    assert float(got[0][1]) == IND * 10 and float(got[0][0]) == IND * 10


@pytest.mark.parametrize("per_problem", [False, True])
def test_banded_global_traced_matches_jax(per_problem):
    """Q + T = 126 is not a multiple of 4: the port pads Q for K4's
    packed plane and cuts the unpacked ops back to Q + T."""
    rng = np.random.default_rng(9)
    K = 10
    q, t, qlen, tlen, kband = bucket(rng, 16, 62, 64, K, 30, 62)
    kb = kband if per_problem else None
    want = np.asarray(jax_call(jak.banded_global_traced, q, t, qlen, tlen,
                               K, kb))
    got = torch_call(tak.banded_global_traced, q, t, qlen, tlen, K, kb)
    assert got.dtype == torch.int8 and got.shape == (16, 126)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == tak.DIAG).any() and (want == -1).any()
