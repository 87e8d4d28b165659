"""P1's launch plan (ops/affine_pallas.rowsync_plan), without JAX and
without a card: every S bucket the row-sync kernel may get keeps each
problem's plane in shared memory while it fits the 227 KB of a block
(problems a block lowered before it falls back to a device plane), and
only a plan with a device plane asks the wrapper for plane scratch."""

import pytest

from lra_tpu_torch.ops import affine_kernel as ak
from lra_tpu_torch.ops import affine_pallas as ap

S_BUCKETS = [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 13664,
             13672, 16384]


@pytest.mark.parametrize("S", S_BUCKETS)
@pytest.mark.parametrize("B", [None, 8, 1055, 1056, 65536])
def test_rowsync_plan_fits(S, B):
    p = ap.rowsync_plan(S, B)
    group = 2 * p["R"] * 16 + ap._plane_width(S) + 16
    assert p["smem"] == p["PPC"] * group <= ak.SMEM_MAX, p
    assert p["threads"] == 32 * p["PPC"] and 1 <= p["PPC"] <= 8, p
    # the wrapper's rule and the kernel's (S + 1 <= 2R) agree, and only a
    # device plane takes scratch
    assert p["smem_plane"] == (S + 1 <= 2 * p["R"]), p
    assert p["plane_bytes"] == (0 if p["smem_plane"] else (S + 1) * 16), p
    # K4's problems a block, lowered only as far as the planes need
    want = ak._per_block(1, B, 132)
    assert p["PPC"] <= want, p
    if p["smem_plane"] and p["PPC"] < want:
        assert (p["PPC"] + 1) * group > ak.SMEM_MAX, p
    # the plane stays in shared memory while one problem's fits a block
    assert p["smem_plane"] == (S <= 13669), p
    if not p["smem_plane"]:
        assert p["PPC"] == want and 1 <= p["R"] <= 64, p


@pytest.mark.parametrize("S", S_BUCKETS)
def test_rowsync_plan_variants(S):
    """Every variant fits a block; the device-plane variants keep the
    plane out of shared memory (any S past one row a chunk)."""
    seen = []
    for name, p in ap.rowsync_plan_variants(S):
        assert p["smem"] <= ak.SMEM_MAX, name
        assert p["plane_bytes"] == (0 if p["smem_plane"]
                                    else (S + 1) * 16), name
        if "device" in name:
            assert not p["smem_plane"], name
        seen.append(p["PPC"])
    assert seen[0] == seen[1] == 1 and seen[3] == 8


@pytest.mark.parametrize("S,B,ppc,R,smem_plane", [
    (16, 2048, 8, 9, True), (32, 2048, 8, 17, True), (64, 1024, 1, 33, True),
    (128, 128, 1, 65, True), (512, 8, 1, 257, True),
    (2048, 1056, 6, 1025, True), (2048, 8, 1, 1025, True),
    (13664, 1056, 1, 6833, True), (13672, 1056, 8, 64, False),
    (16384, 8, 1, 64, False)])
def test_rowsync_plan_tiers(S, B, ppc, R, smem_plane):
    """CCS use_pallas's launches (B, S) = (2048, 16), (2048, 32), (1024,
    64), (128, 128), (8, 512) on a 132-SM card; S = 2048 in a full bucket
    holds 6 problems a block; past S = 13669 no plane fits."""
    p = ap.rowsync_plan(S, B, sms=132)
    assert (p["PPC"], p["R"], p["smem_plane"]) == (ppc, R, smem_plane)
