"""The CUDA kernels' PWL lookup (csrc/pwl.cuh: binary search over the
stops, one effective piece from a host table) == lra_tpu's device PWL
(pwl_select_jnp on JAX-CPU), through its numpy emulation, for every
integer x in 0..120000 (past the last stop, 100000).  Tolerance: exact
(bitwise f32)."""

import jax.numpy as jnp
import numpy as np
import pytest

from lra_tpu import preset
from lra_tpu.ops.gapcost import from_options, pwl_select_jnp
from lra_tpu_torch import preset as t_preset
from lra_tpu_torch.ops.gapcost import (NUMPWL, STOPS, pwl_bucket_index_np,
                                       pwl_effective_pieces, pwl_lookup_np)
from lra_tpu_torch.ops.gapcost import from_options as t_from_options
from lra_tpu_torch.ops.sdp_blocked import _pwl_host_params


@pytest.mark.parametrize("name", ["ccs", "clr", "ont", "contig"])
def test_pwl_lookup_matches_jax(name):
    key = from_options(preset(name)).static_key()
    tkey = t_from_options(t_preset(name)).static_key()
    assert key == tkey
    x = np.arange(120_001, dtype=np.int32)
    want = np.asarray(pwl_select_jnp(jnp.asarray(x), key))
    got = pwl_lookup_np(x, tkey)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the table the kernels get: effective slopes, then intercepts, then
    # the two ceilings; a stop index past the last piece repeats it
    es, ei = pwl_effective_pieces(tkey)
    host = np.ctypeslib.as_array(_pwl_host_params(tkey))
    np.testing.assert_array_equal(host, np.concatenate(
        [es, ei, np.float32([tkey[2], tkey[3]])]))
    assert es[NUMPWL - 1] == es[NUMPWL - 2] and len(STOPS) == NUMPWL
    # the free pieces (left stop <= 10) have no effective piece
    assert not es[STOPS <= 10].any() and not ei[STOPS <= 10].any()


def test_pwl_bucket_index_is_the_search_index():
    """csrc/pwl.cuh's bucketed stop index (pwl_bucketed, K2) == the last
    stop <= x, the binary search's, for every x in 0..200000, the int32
    extremes and negative x (bucket 0; free either way)."""
    x = np.concatenate([np.arange(200_001), [2 ** 31 - 1, 2 ** 31 - 2,
                                             10 ** 9, -1, -7, -2 ** 31]])
    got = pwl_bucket_index_np(x)
    pos = x >= 0
    want = np.searchsorted(STOPS, x[pos], side="right") - 1
    np.testing.assert_array_equal(got[pos], want)
    assert (got[~pos] == 0).all() and got.max() == NUMPWL - 1
