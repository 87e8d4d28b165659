"""K1: the port's PWL gap cost == lra_tpu's device PWL, exactly, for
every x of the dense table."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lra_tpu import preset
from lra_tpu.ops.gapcost import from_options, pwl_np, pwl_select_jnp
from lra_tpu_torch import preset as t_preset
from lra_tpu_torch.ops.gapcost import from_options as t_from_options
from lra_tpu_torch.ops.gapcost import pwl_np as t_pwl_np
from lra_tpu_torch.ops.gapcost import pwl_select_torch

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["ccs", "ont", "contig"])
def test_pwl_select_torch_matches_jax_and_numpy(name):
    """Tolerance: exact (bitwise f32).  lra_tpu's own f32 device PWL and
    its f64 numpy oracle split at one breakpoint (x = 1000: s*x + b lands
    on either side of an integer); the port follows the device function,
    so its disagreements with numpy are exactly lra_tpu's."""
    gp = from_options(preset(name))
    tgp = t_from_options(t_preset(name))
    assert gp.static_key() == tgp.static_key()
    x = np.arange(len(gp.table), dtype=np.int32)
    want = np.asarray(pwl_select_jnp(jnp.asarray(x), gp.static_key()))
    got = pwl_select_torch(torch.from_numpy(x), tgp.static_key()).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ref = pwl_np(x, gp)
    np.testing.assert_array_equal(t_pwl_np(x, tgp), ref)
    split = np.nonzero(got != ref)[0]
    np.testing.assert_array_equal(split, np.nonzero(want != ref)[0])
    assert split.tolist() == [1000]
