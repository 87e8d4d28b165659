"""K4, K5, K6 and the row-sync kernel (P1): the port's plain twins ==
lra_tpu's on the same numpy inputs.  Tolerance: exact everywhere (packed
op planes, P planes, ops/jump/score, decoded blocks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lra_tpu.ops import affine_kernel as jak
from lra_tpu.ops import affine_pallas as jap
from lra_tpu.ops import one_gap as jog
from lra_tpu.utils import pow2_at_least
from lra_tpu_torch.ops import affine_kernel as tak
from lra_tpu_torch.ops import affine_pallas as tap
from lra_tpu_torch.ops import one_gap as tog
from lra_tpu_torch.sim import rowsync_problems

torch.set_num_threads(2)
M, MM, IND = 4, -3, -4


def gap_batch(rng, B, S, K, drift=6):
    """Square [B, S] buckets of gap-like problems (SNPs, an indel),
    lengths drifting within the band."""
    t = rng.integers(0, 4, (B, S)).astype(np.int8)
    q = t.copy()
    for b in range(B):
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(0, S))
            q[b, p] = (q[b, p] + 1) % 4
        if rng.random() < 0.5:
            p = int(rng.integers(1, S - 1))
            q[b, p:] = np.roll(q[b, p:], 1)
    qlen = rng.integers(S // 2, S + 1, B).astype(np.int32)
    tlen = np.clip(qlen + rng.integers(-drift, drift, B), 8,
                   S).astype(np.int32)
    kb = np.minimum(np.maximum(np.abs(qlen - tlen)
                               + rng.integers(0, 8, B), 1), K)
    return q, t, qlen, tlen, kb.astype(np.int32)


def as_j(arrs):
    return [jnp.asarray(a) for a in arrs]


def as_t(arrs, dev="cpu"):
    return [torch.from_numpy(a).to(dev) for a in arrs]


@pytest.mark.parametrize("kind,B,S,K", [
    ("global", 4, 32, 15), ("global", 4, 64, 30), ("global", 3, 48, 64),
    ("global", 2, 40, 512), ("refine", 4, 32, 15), ("refine", 4, 64, 30),
    ("refine", 3, 48, 64)])
def test_banded_plain_matches_jax(kind, B, S, K):
    """K4 (kind "global") and K5 ("refine"): packed op planes."""
    rng = np.random.default_rng(S + K)
    q, t, ql, tl, kb = gap_batch(rng, B, S, K)
    jfn, tfn = {"global": (jak.banded_global_traced_packed,
                           tak.banded_global_traced_packed),
                "refine": (jak.banded_refine_traced_packed,
                           tak.banded_refine_traced_packed)}[kind]
    want = np.asarray(jfn(*as_j((q, t, ql, tl)), K, M, MM, IND,
                          kband=jnp.asarray(kb)))
    got = tfn(*as_t((q, t, ql, tl)), K, M, MM, IND,
              kband=torch.from_numpy(kb)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want != 0).any()


def test_one_gap_plain_matches_jax():
    import sys
    import os
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_one_gap import _gen_case

    rng = np.random.default_rng(17)
    cases = [_gen_case(rng, 120) for _ in range(24)]
    K, D = 16, 1
    for q, t, _ in cases:
        D = max(D, min(len(q), len(t)) + 1)
    D = pow2_at_least(D, 16)
    kb = np.array([min(min(len(q), len(t)), k) for q, t, k in cases],
                  np.int32)
    packed = jog.pack_one_gap_bucket([c[0] for c in cases],
                                     [c[1] for c in cases], K, D)
    tpacked = tog.pack_one_gap_bucket([c[0] for c in cases],
                                      [c[1] for c in cases], K, D)
    for a, b in zip(packed, tpacked):
        np.testing.assert_array_equal(a, b)
    L = 2 * (D + K) + 8
    ops, jump, score = [np.asarray(x) for x in jog.one_gap_traced(
        *packed, kb, K, D, M, MM, IND, L)]
    tops, tjump, tscore = [x.numpy() for x in tog.one_gap_traced(
        *as_t(list(packed) + [kb]), K, D, M, MM, IND, L)]
    np.testing.assert_array_equal(tops, ops)
    np.testing.assert_array_equal(tjump, jump)
    np.testing.assert_array_equal(tscore.view(np.int32), score.view(np.int32))
    for b in range(len(cases)):
        assert tog.blocks_from_one_gap_ops(tops[b], int(tjump[b])) == \
            jog.blocks_from_one_gap_ops(ops[b], int(jump[b]))


@pytest.mark.parametrize("regime", ["query_longer", "target_longer"])
def test_one_gap_plain_matches_jax_regime(regime):
    """K6's twin in each closure regime alone: the query longer (the
    lowerMax column closure, GAPLEFT) or the target longer (the upperMax
    row closure, GAPDOWN)."""
    import sys
    import os
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_one_gap import _gen_case

    rng = np.random.default_rng(23)
    cases = []
    for _ in range(24):
        q, t, k = _gen_case(rng, 120)
        if (len(q) > len(t)) != (regime == "query_longer"):
            q, t = t, q
        cases.append((q, t, k))
    K = 16
    D = pow2_at_least(max(min(len(q), len(t)) + 1 for q, t, _ in cases), 16)
    kb = np.array([min(min(len(q), len(t)), k) for q, t, k in cases],
                  np.int32)
    packed = tog.pack_one_gap_bucket([c[0] for c in cases],
                                     [c[1] for c in cases], K, D)
    L = 2 * (D + K) + 8
    ops, jump, score = [np.asarray(x) for x in jog.one_gap_traced(
        *packed, kb, K, D, M, MM, IND, L)]
    tops, tjump, tscore = [x.numpy() for x in tog.one_gap_traced(
        *as_t(list(packed) + [kb]), K, D, M, MM, IND, L)]
    np.testing.assert_array_equal(tops, ops)
    np.testing.assert_array_equal(tjump, jump)
    np.testing.assert_array_equal(tscore.view(np.int32), score.view(np.int32))
    gap_op = jog.GAPLEFT if regime == "query_longer" else jog.GAPDOWN
    assert all((ops[b] == gap_op).sum() == 1 for b in range(len(cases)))


def rowsync_batch(rng, B, S, n_snp):
    t = rng.integers(0, 4, (B, S)).astype(np.int8)
    q = t.copy()
    for b in range(B):
        for _ in range(int(rng.integers(0, n_snp))):
            p = int(rng.integers(0, S))
            q[b, p] = (q[b, p] + 1) % 4
    qlen = rng.integers(S // 2, S + 1, B).astype(np.int32)
    tlen = np.clip(qlen + rng.integers(-6, 6, B), 4, S).astype(np.int32)
    kb = np.maximum(np.full(B, 30, np.int32), np.abs(qlen - tlen) + 1)
    return q, t, qlen, tlen, kb


def test_rowsync_plain_matches_pallas_interpret():
    """The P plane of the plain twin == the Pallas kernel's, run in
    interpret mode on the CPU (B=8, S=16, K=15: interpret mode is slow)."""
    rng = np.random.default_rng(9)
    B, S, K = 8, 16, 15
    q, t, ql, tl, kb = rowsync_batch(rng, B, S, 3)
    want = np.asarray(jap.banded_pallas_rowsync(
        *as_j((q, t, ql, tl)), K, M, MM, IND, kband=jnp.asarray(kb),
        interpret=True))
    got = tap.banded_pallas_rowsync(*as_t((q, t, ql, tl)), K, M, MM, IND,
                                    kband=torch.from_numpy(kb)).numpy()
    np.testing.assert_array_equal(got, want)


def test_rowsync_plain_matches_pallas_interpret_edges():
    """The row walk's edge problems (sim.rowsync_problems: the pad row,
    qlen 0, tlen 0, starts off the band on either side, kband 3 < K, an
    insertion whose LEFT run reaches row 0): the plain twin's P plane ==
    the Pallas kernel's in interpret mode, at the shape of the test
    above (one compile)."""
    B, S, K = 8, 16, 15
    q, t, ql, tl, kb = rowsync_problems(np.random.default_rng(11), B, S, K)
    assert (ql == 0).any() and (tl == 0).any() and (kb < K).any()
    assert (np.abs(ql - tl) > K).sum() == 2
    want = np.asarray(jap.banded_pallas_rowsync(
        *as_j((q, t, ql, tl)), K, M, MM, IND, kband=jnp.asarray(kb),
        interpret=True))
    got = tap.banded_pallas_rowsync(*as_t((q, t, ql, tl)), K, M, MM, IND,
                                    kband=torch.from_numpy(kb)).numpy()
    np.testing.assert_array_equal(got, want)
    # no row written where the walk starts off the band; a row-0 run
    assert not want[np.abs(ql - tl) > K].any()
    assert ((want[:, 0] >> 2) > 1).any()


def test_rowsync_plain_blocks_match_jax_banded_global():
    """At S=64 (tests/test_affine_kernel.py's TPU-only shape) the plain
    row-sync twin decodes to lra_tpu's banded_global_traced_packed
    blocks."""
    rng = np.random.default_rng(9)
    B, S, K = 8, 64, 15
    q, t, ql, tl, kb = gap_batch(rng, B, S, K)
    ref = jak.blocks_from_ops_batch(jak.unpack_ops(np.asarray(
        jak.banded_global_traced_packed(*as_j((q, t, ql, tl)), K, M, MM,
                                        IND, kband=jnp.asarray(kb)))))
    P = tap.banded_pallas_rowsync(*as_t((q, t, ql, tl)), K, M, MM, IND,
                                  kband=torch.from_numpy(kb)).numpy()
    assert tap.blocks_from_rowsync(P, ql, tl, S) == ref
    assert sum(len(x) for x in ref) > B    # indels split blocks
