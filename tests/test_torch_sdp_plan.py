"""K2's launch plan (ops/sdp_blocked.sdp_plan) and its test bucket,
without JAX and without a card: every N bucket of the chain driver gets a
tier the kernel takes, threads and shared memory a block may use, and the
shared memory the kernel carves; sim.sdp_bucket holds the rows the
kernel's exactness hinges on, as the plain twin reads them."""

import numpy as np
import pytest
import torch

from lra_tpu_torch.chain import driver
from lra_tpu_torch.ops import sdp_blocked as sb
from lra_tpu_torch.sim import sdp_bucket

torch.set_num_threads(2)


@pytest.mark.parametrize("N", driver._BUCKETS)
def test_sdp_plan_covers_every_bucket(N):
    p = sb.sdp_plan(N)
    assert p["threads"] % 32 == 0 and p["smem"] <= sb.SMEM_MAX - 1024, N
    if N == 64:
        assert p == {"tier": 0, "threads": 32, "smem": sb._TRI_BYTES}, N
    else:
        assert p["tier"] == 1 and 128 <= p["threads"] <= 1024, N
        # Tri[2], Staged[2], running bests (f32 + int32 per lane and row),
        # receiver lists (uint16 per lane and row), block starts, lane
        # bits (a byte a row)
        assert p["smem"] == (2 * sb._TRI_BYTES + 2 * sb._STAGED_BYTES
                             + N * (2 * 4 + 2 * 4 + 2 * 2 + 1)
                             + 2 * 4 * (N // 64 + 1)), N
    for v in sb.plan_variants(N):
        assert v["smem"] <= sb.SMEM_MAX - 1024, (N, v)
        assert v["tier"] == 1 or N == 64, (N, v)
    assert sb.plan_variants(N)[0] == p


@pytest.mark.parametrize("N,tier,threads", [
    (64, 0, 32), (128, 1, 128), (256, 1, 128), (512, 1, 256),
    (1024, 1, 512), (2048, 1, 1024), (4096, 1, 1024), (8192, 1, 1024)])
def test_sdp_plan_tiers(N, tier, threads):
    """One problem a block of one warp at N = 64; above, one problem a
    block of 128 threads up to N = 256, N / 2 up to 1024."""
    p = sb.sdp_plan(N)
    assert (p["tier"], p["threads"]) == (tier, threads)


@pytest.mark.parametrize("N", [0, 32, 100, 8256, 16384])
def test_sdp_plan_refuses(N):
    with pytest.raises(ValueError):
        sb.sdp_plan(N)


def test_sdp_bucket_edges_plain():
    """sdp_bucket's rows through the plain twin: an invalid row that keeps
    its lane bits takes a valid predecessor; an all-invalid problem and an
    empty one give (NEG, -1, 0) on every row."""
    from lra_tpu_torch.ops.gapcost import from_options
    from lra_tpu_torch import preset

    key = from_options(preset("ccs")).static_key()
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in sdp_bucket(np.random.default_rng(3), 4, 128)]
    V, bp, lane = sb.chain_scores_blocked(*args, key)
    valid = args[7]
    assert bool(((~valid[0]) & (bp[0] >= 0)).any() |
                ((~valid[3]) & (bp[3] >= 0)).any())
    assert bool(((args[5][1] | args[6][1])).any())
    for b in (1, 2):
        assert bool((V[b] == np.float32(sb.NEG)).all())
        assert bool((bp[b] == -1).all()) and bool((lane[b] == 0).all())
    assert bool((lane == 2).any()) and bool((lane == 1).any())


@pytest.mark.parametrize("N", driver._BUCKETS)
@pytest.mark.parametrize("B", [None, 1, 256, 1055, 1056, 65536])
def test_mask_plan_covers_every_bucket(N, B):
    """K3's plan (sb.mask_plan) for every N bucket: a warp a problem up
    to N = 1024, 8 a block once the bucket gives every SM 8 warps, else
    B // sms (at least one); a CTA a problem above, 8 rows a thread; the
    shared memory the kernel carves (bp and the mask words) within the
    48 KB a block gets without an opt-in."""
    p = sb.mask_plan(N, B, sms=132)
    assert p["threads"] % 32 == 0 and 32 <= p["threads"] <= 1024, p
    assert p["smem"] <= 48 * 1024, p
    if N <= 1024:
        assert p["tier"] == 0 and p["threads"] == 32 * p["ppb"], p
        assert p["ppb"] == min(8, max(1, (B or 0) // 132)), p
        assert p["smem"] == p["ppb"] * 4 * (N + 32), p
    else:
        assert p["tier"] == 1 and p["ppb"] == 1, p
        assert p["threads"] == min(1024, N // 8), p
        assert p["smem"] == 4 * (N + N // 32), p
    names = [n for n, _ in sb.mask_plan_variants(N)]
    assert names[-1] == "CTA tier" and len(names) == (3 if N <= 1024 else 1)
    for _, v in sb.mask_plan_variants(N):
        assert v["smem"] <= 48 * 1024 and v["threads"] <= 1024, v


@pytest.mark.parametrize("N,tier", [(0, None), (48, None), (8224, None),
                                    (16384, None), (2048, 0)])
def test_mask_plan_refuses(N, tier):
    with pytest.raises(ValueError):
        sb.mask_plan(N, 8, tier=tier)
