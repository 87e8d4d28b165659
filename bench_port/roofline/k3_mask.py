"""K3, the chain-mask traceback of the single-best-chain rounds
(csrc/chain_mask.cu).

Frozen from chip_smoke.py:487-495 (``mask_bound``), restricted to the
valid rows: V and valid read once (5 bytes a valid row), one back
pointer read per chain row the walk visits, vmax and the bit words of
each problem written once; 3 operations a valid row (mask, compare,
select) and one a visited row."""

import numpy as np

SITES = (("lra_tpu_torch.chain.driver", "chain_mask_from_scores"),)
DEVICE = ("chain_mask_warp_kernel", "chain_mask_cta_kernel")
OPS_PER_ROW = 3


def bound(args, kw, out):
    valid = np.asarray(args[2], dtype=bool)
    bits = np.asarray(out[1]).astype(np.uint32)
    visited = float(np.unpackbits(bits.view(np.uint8)).sum())
    rows = float(valid.sum())
    real = valid.any(axis=1)
    nbytes = rows * 5 + 4 * visited + float(real.sum()) * (
        4 + 4 * bits.shape[1])
    return rows * OPS_PER_ROW + visited, nbytes
