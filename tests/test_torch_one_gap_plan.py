"""K6's launch plan (ops/one_gap.one_gap_plan) on the CPU, without JAX
and without a card: every K bucket the pipeline makes (16..1024) gets a
tier whose cells cover the band, K <= 32 the warp tier, a block within
the shared memory a block may use, the planes and the gap tables in
device memory exactly where a problem's bytes do not fit in shared
memory, and scratch for what goes there."""

import pytest

from lra_tpu_torch.ops import one_gap as og


def smem_bytes(K, D, tables, planes):
    return og._og_group_bytes(K, D, 2 * (D + K) + 8, tables, planes,
                              og._OG_R)[0]


@pytest.mark.parametrize("K", [16, 32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("D", [16, 512, 2048, 16384])
@pytest.mark.parametrize("B", [1, 8, 704, 705, 4096])
def test_one_gap_plan_covers_every_bucket(K, D, B):
    p = og.one_gap_plan(K, D, B, sms=132)
    LS = 2 * K + 4
    assert p["smem"] <= og.SMEM_MAX
    assert p["threads"] <= 1024 and p["threads"] % 32 == 0
    if K <= 32:
        # a problem's band row in one warp: 32 lanes of CPT cells
        assert p["tier"] == 0 and 32 * p["CPT"] >= LS
        assert p["threads"] == 32 * p["WPP"] * p["PPB"]
        assert p["WPP"] == (1 if 3 * B > og._OG_FULL_WARPS * 132 else 3)
        assert p["PPB"] == 1 or p["WPP"] == 1
        group, tb, pb = og._og_group_bytes(K, D, 2 * (D + K) + 8,
                                           p["tables_smem"],
                                           p["planes_smem"], p["R"])
        assert p["smem"] == p["PPB"] * group
        assert p["scratch"] == B * (tb + pb)
        assert (tb == 0) == bool(p["tables_smem"])
        assert (pb == 0) == bool(p["planes_smem"])
    else:
        # one CTA a problem, CPT cells a thread
        assert p["tier"] == 1 and p["WPP"] * 32 * p["CPT"] >= LS
        assert p["PPB"] == 1 and p["threads"] == 32 * p["WPP"]
        assert not p["tables_smem"] and not p["planes_smem"]
        assert p["smem"] == (3 * LS + 1) * 4
        assert p["scratch"] == og._og_cta_scratch(B, K, D)


@pytest.mark.parametrize("K", [16, 32])
@pytest.mark.parametrize("D", [16, 64, 256, 512, 1024, 2048, 4096, 8192,
                               16384])
def test_one_gap_plan_device_memory_where_it_does_not_fit(K, D):
    """The planes go to device memory exactly where one problem's shared
    bytes with them exceed the limit; the tables too exactly where even
    without the planes they do."""
    p = og.one_gap_plan(K, D, 8, sms=132)
    fits_all = smem_bytes(K, D, True, True) <= og.SMEM_MAX
    fits_tables = smem_bytes(K, D, True, False) <= og.SMEM_MAX
    assert bool(p["planes_smem"]) == fits_all
    assert bool(p["tables_smem"]) == fits_tables
    assert p["scratch"] > 0 or fits_all


@pytest.mark.parametrize("K,D,B,wpp,ppb,tables,planes", [
    (16, 16, 4096, 1, 4, 1, 1),     # ONT's main-path bucket: full
    (16, 16, 512, 3, 1, 1, 1),      # CLR's: three warps a problem
    (32, 512, 8, 3, 1, 1, 1),       # the longest rows, planes on chip
    (32, 512, 16, 3, 1, 1, 1),
    (32, 1024, 8, 3, 1, 1, 1),
    (32, 2048, 8, 3, 1, 1, 0),      # planes past shared memory
    (16, 2048, 8, 3, 1, 1, 1),
    (16, 4096, 8, 3, 1, 1, 0),
    (32, 16384, 8, 3, 1, 0, 0),     # tables past it too
    (16, 512, 4096, 1, 4, 1, 1),
    (32, 512, 4096, 1, 2, 1, 1),    # 4 a block do not fit: 2
    (32, 1024, 4096, 1, 1, 1, 1)])
def test_one_gap_plan_shapes(K, D, B, wpp, ppb, tables, planes):
    p = og.one_gap_plan(K, D, B, sms=132)
    assert (p["WPP"], p["PPB"], p["tables_smem"], p["planes_smem"]) == \
        (wpp, ppb, tables, planes)


@pytest.mark.parametrize("K,D,B", [(16, 16, 4096), (32, 512, 16),
                                   (32, 2048, 8), (64, 64, 13)])
def test_one_gap_plan_variants(K, D, B):
    """The wrapper's plan comes first; every variant is a valid plan of the
    same tier within the shared memory limit, and no two are alike."""
    vs = og.plan_variants(K, D, B)
    assert vs[0] == ("plan", og.one_gap_plan(K, D, B))
    plans = [p for _, p in vs]
    assert all(p["smem"] <= og.SMEM_MAX for p in plans)
    assert all(p["tier"] == plans[0]["tier"] for p in plans)
    assert len({tuple(sorted(p.items())) for p in plans}) == len(plans)
    if K <= 32:
        assert {p["WPP"] for p in plans} == {1, 3}


def test_one_gap_plan_refuses():
    with pytest.raises(ValueError):
        og.one_gap_plan(2048, 16, 8)
