"""K8, the unblocked chaining scan: the port's pwl_torch and
chain_scores_plain == lra_tpu's pwl_jnp and ops/sdp.py:chain_scores on
the same numpy inputs.  Tolerance: exact (f32 compared bit for bit, bp
and lane equal on every row, invalid rows included)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lra_tpu import preset as jpreset
from lra_tpu.ops import sdp as jsdp
from lra_tpu.ops.gapcost import GapParams as JGapParams
from lra_tpu.ops.gapcost import from_options as jfrom_options
from lra_tpu.ops.gapcost import pwl_jnp, pwl_select_jnp
from lra_tpu_torch.ops import sdp as tsdp
from lra_tpu_torch.ops.gapcost import pwl_select_torch, pwl_torch
from lra_tpu_torch.sim import SCAN_KINDS, scan_bucket, zero_slope_piece

torch.set_num_threads(2)


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def hand_params():
    """The CCS parameters with a zero-slope piece of nonzero intercept
    (sim.zero_slope_piece): pwl_jnp takes it at face value,
    pwl_select_jnp skips it and keeps piece 5."""
    gp = jfrom_options(jpreset("ccs"))
    return JGapParams(*zero_slope_piece(gp.slope, gp.inter), gp.ceiling1,
                      gp.ceiling2)


@pytest.mark.parametrize("name", ["ccs", "ont", "clr", "contig", "hand"])
def test_pwl_torch_matches_pwl_jnp(name):
    gp = hand_params() if name == "hand" else \
        jfrom_options(jpreset(name))
    xs = np.arange(0, 120001, dtype=np.int32)
    want = np.asarray(pwl_jnp(jnp.asarray(xs), jnp.asarray(gp.slope),
                              jnp.asarray(gp.inter), gp.ceiling1,
                              gp.ceiling2))
    got = pwl_torch(torch.from_numpy(xs), gp.slope, gp.inter, gp.ceiling1,
                    gp.ceiling2).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))
    if name == "hand":
        # the case the hand-made parameters exist for: the two PWL forms
        # differ, and the port's select chain follows lra_tpu's
        sel = np.asarray(pwl_select_jnp(jnp.asarray(xs), gp.static_key()))
        assert (sel != want).any()
        tsel = pwl_select_torch(torch.from_numpy(xs), gp.static_key())
        np.testing.assert_array_equal(bits(tsel.numpy()), bits(sel))


@pytest.mark.parametrize("kind", SCAN_KINDS)
def test_chain_scores_plain_matches_jax(kind):
    """B=3, N=64 of each sim.scan_bucket kind: both lanes, one lane,
    invalid rows, unsorted fragments, tie-dense problems."""
    gp = jfrom_options(jpreset("ccs"))
    arrs = scan_bucket(np.random.default_rng(SCAN_KINDS.index(kind)), 3, 64,
                       kind)
    want = jsdp.chain_scores(*[jnp.asarray(a) for a in arrs],
                             jnp.asarray(gp.slope), jnp.asarray(gp.inter),
                             gp.ceiling1, gp.ceiling2)
    got = tsdp.chain_scores(*[torch.from_numpy(a) for a in arrs],
                            gp.slope, gp.inter, gp.ceiling1, gp.ceiling2)
    for name, w, g in zip(("V", "bp", "lane"), want, got):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(bits(g.numpy()), bits(w),
                                      err_msg=name)
    V, bp, lane = (np.asarray(x) for x in want)
    assert (bp >= 0).any()
    if kind == "invalid":
        # the trap: bp and lane are emitted for invalid rows too
        assert ((bp >= 0) & ~arrs[7]).any()
    if kind in ("both_lanes", "tie"):
        assert (lane == 2).any() and (lane == 1).any()
