"""K2, the blocked chaining SDP (csrc/sdp_blocked.cu).

Frozen from chip_smoke.py:438-443 (``sdp_bound``) and OPS_PER_PAIR
(chip_smoke.py:158), restricted to the valid rows: every pair j < i of a
problem's n valid fragments at 40 operations (masks, |d| + 1, the PWL
piece, a multiply, an add, a floor, clamps, V + w, a max, on both
lanes); per valid row its coordinates, score and flags read once
(23 bytes) and V, bp and lane written once (12 bytes)."""

import numpy as np

SITES = (("lra_tpu_torch.chain.driver", "chain_scores_blocked"),)
DEVICE = ("sdp_blocked_warp_kernel", "sdp_blocked_cta_kernel")
OPS_PER_PAIR = 40


def bound(args, kw, out):
    n = np.asarray(args[7], dtype=bool).sum(axis=1).astype(np.float64)
    pairs = float((n * (n - 1) / 2).sum())
    return pairs * OPS_PER_PAIR, float(n.sum()) * (23 + 12)
