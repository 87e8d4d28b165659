"""Fused banded alignment + row-synchronous traceback (the port of
lra_tpu's one Pallas TPU kernel, ops/affine_pallas.py).

The forward pass is the linear-gap banded DP of ops/affine_kernel.py
(same recurrence, masks and tie order).  The traceback is
*row-synchronous*: every alignment path visits each DP row at most once
(a run of LEFT ops within the row, then exactly one DIAG or DOWN that
moves to the previous row), so one step per row suffices:

    rl  = length of the LEFT run ending at the current cell
    a2  = the arrow after the run: DIAG (1), DOWN (2), or stop (3)
    emit P[b, j] = rl << 2 | code;  i -= rl + (a2 == DIAG);  j -= 1

The [B, SP] uint8 P plane (SP = ceil((S+1)/128)*128, zero where no row
was visited) is the only output; the host reconstructs match blocks
from it with cumulative sums (blocks_from_rowsync).

Constraints (pallas_supported): square buckets (Q == T == S, S % 8 == 0)
and band 2K+1 <= 63, so the run length fits 6 bits — the narrow
gap-closing tier; wider tiers use banded_global_traced_packed.

``banded_pallas_rowsync`` launches the CUDA kernel (csrc/banded_global.cu's
rowsync_kernel: K4's forward rows, then the row walk over K4's 2-bit
plane, on ``rowsync_plan``'s launch plan) for CUDA tensors and runs
``banded_pallas_rowsync_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..align.affine import DIAG, DOWN, LEFT
from . import _ext
from .affine_kernel import (SMEM_MAX, _per_block, _shift_right,
                            banded_arrows_plain)


def _tile_rows(S: int, BANDP: int) -> int:
    budget = 4 * 1024 * 1024
    bt = max(1, budget // ((S + 1) * BANDP))
    p = 1
    while p * 2 <= bt:
        p *= 2
    return min(p, 128)


def pallas_supported(S: int, K: int, B: int) -> bool:
    """The reference's gate, kept as is so the port routes the same
    buckets to the row-sync kernel: square buckets, band within 63 cells
    (6-bit run lengths), and the TPU kernel's exact grid tiling."""
    if not (2 * K + 1 <= 63 and S % 8 == 0):
        return False
    BT = min(_tile_rows(S, 128), B)
    R = min(S, 64)
    return B % BT == 0 and S % R == 0


def _plane_width(S: int) -> int:
    return ((S + 1 + 127) // 128) * 128


def banded_pallas_rowsync(q, t, qlen, tlen, K, m, mm, indel, kband=None):
    """Banded DP + traceback; returns the P row-code plane uint8[B, SP].

    q, t: int8 [B, S]; qlen/tlen/kband: int32 [B].  Decode with
    blocks_from_rowsync.  Requires 2K+1 <= 63."""
    B, S = q.shape
    if 2 * K + 1 > 63:
        raise ValueError(f"banded_pallas_rowsync: band {2 * K + 1} > 63")
    if kband is None:
        kband = torch.full((B,), K, dtype=torch.int32, device=q.device)
    if q.device.type == "cuda":
        return _rowsync_cuda(q, t, qlen, tlen, kband, K, m, mm, indel)
    return banded_pallas_rowsync_plain(q, t, qlen, tlen, K, m, mm, indel,
                                       kband)


def banded_pallas_rowsync_plain(q, t, qlen, tlen, K, m, mm, indel, kband):
    """Plain torch twin: the shared forward pass, then one vectorized
    step per row j = S..0 over the batch (lra_tpu _kernel's tb_row)."""
    B, S = q.shape
    band = 2 * K + 1
    dev = q.device
    arrows = banded_arrows_plain(q, t, qlen, tlen, K, m, mm, indel, kband)
    SP = _plane_width(S)
    P = torch.zeros((B, SP), dtype=torch.int64, device=dev)
    iv = qlen.to(torch.int64)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    tlen64 = tlen.to(torch.int64)
    barange = torch.arange(B, device=dev)
    for j in range(S, -1, -1):
        slab = arrows[j].to(torch.int64)                    # [B, band]
        started = tlen64 >= j
        here = active & started
        dk = iv - j + K
        ok = here & (dk >= 0) & (dk < band)
        d = dk.clamp(0, band - 1)
        # LEFT-run length ending at each cell (log-step doubling)
        rl = (slab == LEFT).to(torch.int64)
        sh = 1
        while sh < 64:
            rl = torch.where(rl == sh, rl + _shift_right(rl, sh, 0), rl)
            sh *= 2
        rl_b = rl[barange, d]
        d2 = (d - rl_b).clamp(0, band - 1)
        a2 = slab[barange, d2]
        is_diag = a2 == DIAG
        moved = ok & (is_diag | (a2 == DOWN))
        code = torch.where(is_diag, 1, torch.where(a2 == DOWN, 2, 3))
        P[:, j] = torch.where(ok, (rl_b << 2) | code, P[:, j])
        iv = iv - torch.where(moved, rl_b + is_diag.to(torch.int64), 0)
        active = active & torch.where(started, moved, True)
    return P.to(torch.uint8)


_RS_P = 16           # plane bytes a row: K4's CPT 2 ballot words
_RS_CHUNK_ROWS = 64  # rows a staged chunk of a global plane


def rowsync_plan(S: int, B: int | None = None, sms: int = 132,
                 smem_plane: bool = True) -> dict:
    """Launch plan of csrc/banded_global.cu's rowsync_kernel (P1) for B
    problems of S rows on a card of `sms` SMs: K4's CPT 2 tier on one
    warp a problem, PPC problems a block (K4's _per_block: 8 when the
    bucket gives every SM a block of 8 warps, else one), a plane of 16 B
    a row.  A problem's shared memory: two chunks of R plane rows, its
    staged row of P (SP bytes) and its problem indices (16 bytes).  With
    smem_plane, each problem's whole plane stays in shared memory: R =
    ceil((S+1)/2), so that S + 1 <= 2R (the kernel's rule), PPC lowered
    until the block fits the 227 KB a block may use.  Where not even one
    problem fits (S > 13669), or without smem_plane, the plane lies in
    device memory ("smem_plane": False) and the walk reads it over staged
    chunks of R < (S+1)/2 rows, at most 64; "plane_bytes" is the device
    plane's size a problem (0 with the plane in shared memory)."""
    SP = _plane_width(S)
    ppc = _per_block(1, B, sms)
    R = (S + 2) // 2
    fit = ppc
    while fit > 1 and fit * (2 * R * _RS_P + SP + 16) > SMEM_MAX:
        fit -= 1
    if smem_plane and fit * (2 * R * _RS_P + SP + 16) <= SMEM_MAX:
        ppc = fit
    else:
        R = max(1, min(_RS_CHUNK_ROWS, S // 2))
    in_smem = S + 1 <= 2 * R
    return {"PPC": ppc, "R": R, "smem": ppc * (2 * R * _RS_P + SP + 16),
            "threads": 32 * ppc, "smem_plane": in_smem,
            "plane_bytes": 0 if in_smem else (S + 1) * _RS_P}


def rowsync_plan_variants(S: int) -> list:
    """P1's launch plans for S rows, by name: one problem a block and a
    full bucket's (1 << 20 problems fill any card), each with the plane
    in shared memory where it fits and in device memory."""
    return [(f"{size}, {where}", rowsync_plan(S, B, smem_plane=sm))
            for size, B in (("one a block", 1), ("full bucket", 1 << 20))
            for where, sm in (("shared plane", True),
                              ("device plane", False))]


_ROWSYNC_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
_RS_KEYS = ("PPC", "R", "smem", "plane_bytes")


@functools.lru_cache(maxsize=None)
def _rowsync_plan_args(S: int, B: int, sms: int) -> tuple:
    plan = rowsync_plan(S, B, sms)
    return tuple(plan[k] for k in _RS_KEYS)


def _rowsync_cuda(q, t, qlen, tlen, kband, K, m, mm, indel, plan=None):
    """P1 on the card with rowsync_plan's plan for this bucket (or the one
    given).  One scratch allocation: the problem counter (16 bytes), then
    the plane [B, S+1, 16] only where the plan keeps it in device
    memory.  The kernel writes every byte of P."""
    B, S = q.shape
    _ext.check("q", q, torch.int8, (B, S))
    _ext.check("t", t, torch.int8, (B, S))
    for name, x in (("qlen", qlen), ("tlen", tlen), ("kband", kband)):
        _ext.check(name, x, torch.int32, (B,))
    SP = _plane_width(S)
    P = torch.empty((B, SP), dtype=torch.uint8, device=q.device)
    if B == 0:
        return P
    ppc, R, smem, plane_bytes = (
        _rowsync_plan_args(S, B, _ext.sm_count(q.device.index or 0))
        if plan is None else tuple(plan[k] for k in _RS_KEYS))
    scratch = torch.empty(16 + B * plane_bytes, dtype=torch.uint8,
                          device=q.device)
    p = _ext.ptr
    _ext.launch("banded_pallas_rowsync", "banded_global",
                "lra_banded_pallas_rowsync", _ROWSYNC_ARGS, p(q), p(t),
                p(qlen), p(tlen), p(kband), p(scratch) + 16, p(P),
                p(scratch), B, S, SP, K, int(m), int(mm), int(indel), ppc,
                R, smem)
    return P


def blocks_from_rowsync(P: np.ndarray, qlen: np.ndarray,
                        tlen: np.ndarray, S: int):
    """Vectorized host decode of the P plane -> per-problem block lists.

    P[b, j] = rl << 2 | code for each visited DP row j (code 1 DIAG,
    2 DOWN, 3 stop); the q position of the row-j match is recovered from
    suffix sums of per-row q consumption (rl + DIAG).
    """
    B = P.shape[0]
    P = P[:, :S + 1].astype(np.int64)
    code = P & 3
    rl = P >> 2
    # a stop row consumes its LEFT run but emits no match; rows after the
    # stop (smaller j) are unvisited (code 0)
    visited = code != 0
    dq = np.where(visited, rl + (code == 1), 0)
    # i BEFORE processing row j = qlen - (q consumed at rows > j)
    csum = np.cumsum(dq[:, ::-1], axis=1)[:, ::-1]       # sum over j' >= j
    q_match = qlen[:, None] - csum                        # i after row j
    is_m = code == 1
    # match at row j aligns q_match[b, j] (0-based) to t = j-1.  Row j's
    # LEFT run sits BETWEEN match j and match j+1 in alignment order, so
    # a new block starts at row j when row j-1 wasn't a match or row
    # j-1's run was nonzero
    prev_m = np.zeros_like(is_m)
    prev_m[:, 1:] = is_m[:, :-1]
    prev_rl = np.zeros_like(rl)
    prev_rl[:, 1:] = rl[:, :-1]
    start = is_m & (~prev_m | (prev_rl > 0))
    sb, sj = np.nonzero(start)
    # run continues at j+1 iff j+1 matches and row j's run is zero
    nxt_cont = np.zeros_like(is_m)
    nxt_cont[:, :-1] = is_m[:, 1:] & (rl[:, :-1] == 0)
    eb, ej = np.nonzero(is_m & ~nxt_cont)
    lens = ej - sj + 1
    qv = q_match[sb, sj]
    tv = sj - 1
    cuts = np.searchsorted(sb, np.arange(1, B))
    rows = list(zip(qv.tolist(), tv.tolist(), lens.tolist()))
    out = []
    prev = 0
    for c in list(cuts) + [len(rows)]:
        out.append(rows[prev:c])
        prev = c
    return out
