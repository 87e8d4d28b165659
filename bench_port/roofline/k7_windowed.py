"""K7, the windowed chaining SDP for problems past 8192 fragments
(csrc/sdp_windowed.cu).

Frozen from chip_smoke.py:458-484 (``windowed_bound``): per block of 64
rows its valid rows against the valid rows of its near window
[b0 - W, b0) and the in-block triangle, at 40 operations a pair; the
6 squarings of the 64 x 64 closure (an add and a max a term) of each
block that holds a valid row; the two prefix-max scans over the valid
rows per refresh round; each valid row's inputs read once and V, bp,
lane written once (61 bytes), 4 bytes a block."""

import numpy as np

SITES = (("lra_tpu_torch.chain.driver", "chain_scores_windowed"),)
DEVICE = ("sdp_windowed_kernel",)
OPS_PER_PAIR = 40
L = 64


def _refresh_blocks(W: int, N: int) -> int:
    """Blocks between two refreshes of the far lists (frozen from
    lra_tpu_torch/ops/sdp_windowed.py:57-66): W / 2L, halved until it
    divides the block count."""
    nb = max(1, N // L)
    R = max(1, W // (2 * L))
    while nb % R:
        R //= 2
    return R


def bound(args, kw, out):
    valid = np.asarray(args[7], dtype=bool)
    W = int(kw.get("W", 4096))
    B, N = valid.shape
    per_block = valid.reshape(B, N // L, L).sum(2).astype(np.float64)
    cum = np.concatenate([np.zeros((B, 1)), valid.cumsum(1)], 1)
    b0 = np.arange(0, N, L)
    window = cum[:, b0] - cum[:, np.maximum(b0 - W, 0)]
    pairs = float((per_block * window
                   + per_block * (per_block - 1) / 2).sum())
    live = float((per_block > 0).sum())
    rows = float(valid.sum())
    scans = ((N // L) // _refresh_blocks(W, N)) * 2 * 2 * rows
    ops = pairs * OPS_PER_PAIR + live * 6 * L ** 3 * 2 + scans
    return ops, rows * 61 + live * 4
