"""Batched banded alignment on device: kernels K4 (banded global DP)
and K5 (indel-refine DP), each with its device traceback.

Device version of the banded-global variant of the reference's
``AffineOneGapAlign`` (reference: AffineOneGapAlign.h:194-201 doubled-band
case; the separated prefix/suffix one-long-gap case — |qLen-tLen| > 2k —
runs in ops/one_gap.py).

Formulation: rows j = 1..T, the band is 2K+1 diagonal offsets d with
i = j + d - K.  Within-row query-gap chains (LEFT arrows) are a max-plus
prefix closure over d.  Tie-break order (ins > del > match) and the
i=0 / j=0 boundary initialization match the reference exactly.  The
traceback walks from (qlen, tlen) on the device, one op per step, and
the ops come back packed 2 bits each (LEFT/DOWN/DIAG = 1/2/3, 0 = end).

``banded_global_traced_packed`` and ``banded_refine_traced_packed``
launch the CUDA kernels (csrc/banded_global.cu, csrc/banded_refine.cu)
for CUDA tensors and run their plain torch twins (``*_plain``, a python
loop over rows and over traceback steps) for CPU tensors.  All DP values
are small integers in f32, so the two agree exactly.  The numpy mirrors
below (``banded_global_np``, ``banded_refine_np`` and the host
tracebacks) are the host path's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..align.affine import DIAG, DONE, DOWN, LEFT, MISSING
from . import _ext

NEGF = -1.0e30    # float32(-1e30): the "unreachable" DP value


def _shift_left(x, fill):
    """x[:, d+1] at d, `fill` at the last column."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def _shift_right(x, sh, fill):
    """x[:, d-sh] at d, `fill` in the first sh columns."""
    return torch.cat([torch.full_like(x[:, :sh], fill), x[:, :-sh]], dim=1)


def _qpad(q, K, T):
    """q codes padded with 5 so row j's window qpad[:, j:j+band] holds
    q[i-1] for the band's cells i = j + d - K."""
    B, Q = q.shape
    qpad = torch.full((B, Q + 2 * K + T + 2), 5, dtype=torch.int32,
                      device=q.device)
    qpad[:, K + 1:K + 1 + Q] = q.to(torch.int32)
    return qpad


def _pack_ops(ops):
    """int8 [B, L] ops (-1 past the end) -> uint8 [B, L/4], 2 bits each."""
    o = torch.where(ops < 0, torch.zeros_like(ops), ops).to(torch.uint8)
    return (o[:, 0::4] | (o[:, 1::4] << 2) | (o[:, 2::4] << 4)
            | (o[:, 3::4] << 6))


def banded_arrows_plain(q, t, qlen, tlen, K, m, mm, indel, kband):
    """Forward pass of the linear-gap banded DP (lra_tpu _banded_arrows):
    arrows int8 [T+1, B, 2K+1], arrows[j, b, d] the op at cell
    i = j + d - K (-1 outside the valid cells).  Shared by the plain
    twins of K4 and of the row-sync kernel (ops/affine_pallas.py)."""
    B, Q = q.shape
    T = t.shape[1]
    band = 2 * K + 1
    dev = q.device
    offs = torch.arange(-K, K + 1, dtype=torch.int32, device=dev)[None, :]
    in_band = (offs >= -kband[:, None]) & (offs <= kband[:, None])
    qpad = _qpad(q, K, T)
    t32 = t.to(torch.int32)
    qlen_, tlen_ = qlen[:, None], tlen[:, None]
    negf = torch.tensor(NEGF, dtype=torch.float32, device=dev)
    log_steps = int(np.ceil(np.log2(band)))

    row = torch.where((offs >= 0) & in_band, float(indel) * offs.float(),
                      negf)
    arrows = torch.empty((T + 1, B, band), dtype=torch.int8, device=dev)
    a0 = torch.where(offs > 0, LEFT, torch.where(offs == 0, DONE, -1))
    arrows[0] = torch.where(in_band, a0, -1).to(torch.int8)
    for j in range(1, T + 1):
        prev = row
        qrow = qpad[:, j:j + band]
        sub = torch.where(qrow == t32[:, j - 1:j], float(m), float(mm))
        sMat = prev + sub
        sDel = _shift_left(prev, NEGF) + float(indel)
        base = torch.maximum(sMat, sDel)
        i_vals = j + offs
        is_i0 = i_vals == 0
        base = torch.where(is_i0, float(indel) * j, base)
        valid = (i_vals >= 0) & (i_vals <= qlen_) & (j <= tlen_) & in_band
        base = torch.where(valid, base, negf)
        row = base
        for s in range(log_steps):
            sh = 1 << s
            row = torch.maximum(row, _shift_right(row, sh, NEGF)
                                + float(indel) * sh)
        row = torch.where(valid, row, negf)
        row_left = _shift_right(row, 1, NEGF)
        arr = torch.where(row == row_left + float(indel), LEFT,
                          torch.where(row == sDel, DOWN, DIAG))
        arr = torch.where(is_i0, DOWN, arr)
        arrows[j] = torch.where(valid, arr, -1).to(torch.int8)
    return arrows


def _traceback_ops_plain(arrows, qlen, tlen, K, L):
    """lra_tpu _traceback_ops_device: walk every problem from
    (qlen, tlen), one op per step -> int8 [B, L] end-first, -1 padded."""
    T1, B, band = arrows.shape
    dev = arrows.device
    arr_b = arrows.permute(1, 0, 2)
    barange = torch.arange(B, device=dev)
    i = qlen.to(torch.int64)
    j = tlen.to(torch.int64)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    ops = torch.full((B, L), -1, dtype=torch.int8, device=dev)
    for s in range(L):
        if s % 64 == 0 and not bool(active.any()):
            break
        d = i - j + K
        ok = active & (i >= 0) & (j >= 0) & (d >= 0) & (d < band)
        a = arr_b[barange, j.clamp(0, T1 - 1), d.clamp(0, band - 1)]
        a = torch.where(ok & (a != DONE), a, torch.full_like(a, -1))
        active = a >= 0
        i = i - ((a == DIAG) | (a == LEFT)).to(torch.int64)
        j = j - ((a == DIAG) | (a == DOWN)).to(torch.int64)
        ops[:, s] = a
    return ops


def banded_global_traced_packed_plain(q, t, qlen, tlen, K, m, mm, indel,
                                      kband):
    arrows = banded_arrows_plain(q, t, qlen, tlen, K, m, mm, indel, kband)
    L = q.shape[1] + t.shape[1]
    return _pack_ops(_traceback_ops_plain(arrows, qlen, tlen, K, L))


def _kband_or_full(kband, B, K, dev):
    if kband is None:
        return torch.full((B,), K, dtype=torch.int32, device=dev)
    return kband


def banded_global_traced_packed(q, t, qlen, tlen, K, m, mm, indel,
                                kband=None):
    """Banded DP + device traceback, ops packed 2 bits each.

    q: int8 [B, Q], t: int8 [B, T], qlen/tlen/kband: int32 [B] (kband <=
    K, |qlen - tlen| <= kband).  Returns uint8 [B, (Q+T)/4]."""
    if (q.shape[1] + t.shape[1]) % 4:
        raise ValueError("packed traceback requires Q+T to be a multiple "
                         "of 4")
    kband = _kband_or_full(kband, q.shape[0], K, q.device)
    if q.device.type == "cuda":
        return _banded_cuda("banded_global_traced_packed", "banded_global",
                            "lra_banded_global_traced_packed", q, t, qlen,
                            tlen, kband, K, m, mm, indel)
    return banded_global_traced_packed_plain(q, t, qlen, tlen, K, m, mm,
                                             indel, kband)


_BANDED_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7


def _banded_cuda(kernel, lib, fn, q, t, qlen, tlen, kband, K, m, mm,
                 indel):
    B, Q = q.shape
    T = t.shape[1]
    band = 2 * K + 1
    if band > 2048:
        raise ValueError(f"{kernel} kernel: band {band} > 2048")
    _ext.check("q", q, torch.int8, (B, Q))
    _ext.check("t", t, torch.int8, (B, T))
    for name, x in (("qlen", qlen), ("tlen", tlen), ("kband", kband)):
        _ext.check(name, x, torch.int32, (B,))
    scratch = torch.empty((B, T + 1, band), dtype=torch.int8,
                          device=q.device)
    out = torch.empty((B, (Q + T) // 4), dtype=torch.uint8, device=q.device)
    if B == 0:
        return out
    p = _ext.ptr
    _ext.launch(kernel, lib, fn, _BANDED_ARGS, p(q), p(t), p(qlen), p(tlen),
                p(kband), p(scratch), p(out), B, Q, T, K, int(m), int(mm),
                int(indel))
    return out


def unpack_ops(packed: np.ndarray, mark_term: bool = True) -> np.ndarray:
    """Host inverse of the device 2-bit packing -> int8 [B, L] with -1
    after termination (blocks_from_ops_batch's input format).

    mark_term=False skips the 0 -> -1 rewrite pass: the packed
    terminator 0 (== DONE) is neither DIAG nor LEFT/DOWN, so consumers
    that only classify ops (blocks_from_ops_batch) don't need it."""
    B, L4 = packed.shape
    out = np.empty((B, L4 * 4), np.int8)
    out[:, 0::4] = packed & 3
    out[:, 1::4] = (packed >> 2) & 3
    out[:, 2::4] = (packed >> 4) & 3
    out[:, 3::4] = (packed >> 6) & 3
    if mark_term:
        out[out == 0] = -1
    return out


def blocks_from_ops_batch(ops: np.ndarray):
    """Vectorized blocks_from_ops_row over the whole bucket.

    ops: int8[B, L] device-traceback planes (end-first, -1 padded).
    Returns a list of B block lists [(q_off, t_off, len)].
    """
    B, L = ops.shape
    # ops are end-of-alignment-first; instead of reversing each row,
    # compute alignment-order offsets from suffix counts: the q offset of
    # an element is the number of q-consuming ops AFTER it in array order.
    is_diag = ops == DIAG
    qstep = is_diag | (ops == LEFT)
    tstep = is_diag | (ops == DOWN)
    cdtype = np.int16 if L < 32768 else np.int32
    cq = qstep.cumsum(axis=1, dtype=cdtype)          # inclusive prefix
    ct = tstep.cumsum(axis=1, dtype=cdtype)
    tq = cq[:, -1]
    tt = ct[:, -1]
    prev_diag = np.concatenate(
        [np.zeros((B, 1), bool), is_diag[:, :-1]], axis=1)
    next_diag = np.concatenate(
        [is_diag[:, 1:], np.zeros((B, 1), bool)], axis=1)
    sb, sj = np.nonzero(is_diag & ~prev_diag)        # run starts (array order)
    _, ej = np.nonzero(is_diag & ~next_diag)         # run ends (paired)
    lens = ej - sj + 1
    # run's first base in alignment order is its LAST array element (ej)
    qv = tq[sb] - cq[sb, ej]
    tv = tt[sb] - ct[sb, ej]
    rows = list(zip(qv.tolist(), tv.tolist(), lens.tolist()))
    # nonzero is row-major: split at row boundaries; array order is
    # end-first, so reverse each row's slice into ascending-q order
    cuts = np.searchsorted(sb, np.arange(1, B))
    out = []
    prev = 0
    for c in list(cuts) + [len(rows)]:
        out.append(rows[prev:c][::-1])
        prev = c
    return out


def blocks_from_ops_row(row: np.ndarray):
    """One problem's device-traceback ops (end-first, -1 padded) ->
    [(q_off, t_off, len)] match blocks, same semantics as
    traceback_banded."""
    neg = np.nonzero(row < 0)[0]
    n = int(neg[0]) if len(neg) else len(row)
    if n == 0:
        return []
    ops = row[:n][::-1]
    change = np.nonzero(np.diff(ops))[0]
    starts = np.concatenate(([0], change + 1))
    lens = np.diff(np.concatenate((starts, [n])))
    vals = ops[starts]
    dq = np.where((vals == LEFT) | (vals == DIAG), lens, 0)
    dt = np.where((vals == DOWN) | (vals == DIAG), lens, 0)
    qoff = np.cumsum(dq) - dq
    toff = np.cumsum(dt) - dt
    sel = vals == DIAG
    return list(zip(qoff[sel].tolist(), toff[sel].tolist(),
                    lens[sel].tolist()))


def traceback_banded(arrows: np.ndarray, qlen: int, tlen: int, K: int):
    """Host traceback of one problem's arrow plane.

    Returns (blocks, ops) like align.affine.affine_one_gap_align.
    """
    i, j = int(qlen), int(tlen)
    ops: list = []
    lengths: list = []
    while i >= 0 and j >= 0:
        d = i - j + K
        if d < 0 or d >= arrows.shape[1]:
            break
        a = int(arrows[j, d])
        if a in (DONE, -1):
            break
        if not ops or ops[-1] != a:
            ops.append(a)
            lengths.append(1)
        else:
            lengths[-1] += 1
        if a == DIAG:
            i -= 1
            j -= 1
        elif a == LEFT:
            i -= 1
        elif a == DOWN:
            j -= 1
        else:
            break
    blocks = []
    out_ops = []
    qPos = tPos = 0
    for op, ln in zip(ops[::-1], lengths[::-1]):
        if op == LEFT:
            qPos += ln
        elif op == DOWN:
            tPos += ln
        elif op == DIAG:
            blocks.append((qPos, tPos, ln))
            qPos += ln
            tPos += ln
        out_ops.append((op, ln))
    return blocks, out_ops


# ---------------------------------------------------------------------------
# Indel-refine DP: the reference's IndelRefineAlignment matrix
# (reference: IndelRefine.h:339-612) — linear single-step gaps (cost
# `indel`) PLUS affine lanes with gapOpen = 2*indel+1 and gapExtend = 0,
# so a gap run of length g costs max(g*indel, open): length-1 gaps stay
# linear, longer gaps consolidate under one open.  Main-matrix tie order
# is match > ins(linear) > del(linear) > delClose > insClose
# (IndelRefine.h:585-612); within each lane, open beats extend on ties
# (IndelRefine.h:504-512).  The first q/t base of the window is force-
# paired at zero score (IndelRefine.h:674 pushes the final diag;
# "The first base is always aligned here") — callers pass the window
# SHIFTED by one base and prepend the (0,0,1) block — and the i=0
# column is a rail for j >= 1 (IndelRefine.h:414: row-start cells BAD),
# so the region cannot open with a target deletion.
#
# With gapExtend = 0 the within-row recurrence collapses: the ins lane
# is I[d] = prefixmax(base)[d-1] + open (one open covers any run
# length), and S[d] = max(leftclosure(base)[d], I[d]) — two log-doubling
# closures, same cost class as the linear kernel.
# ---------------------------------------------------------------------------

REF_DELC = 4   # main arrow: close a target-gap (del) affine run
REF_INSC = 5   # main arrow: close a query-gap (ins) affine run
_DEL_OPEN_BIT = 8
_INS_OPEN_BIT = 16


def refine_planes_plain(q, t, qlen, tlen, K, m, mm, indel, kband):
    """Forward pass of the indel-refine DP (lra_tpu _refine_arrows):
    planes int8 [T+1, B, 2K+1] = main arrow | delOpen << 3 |
    insOpen << 4, -1 at rails."""
    B, Q = q.shape
    T = t.shape[1]
    band = 2 * K + 1
    open_ = float(2 * indel + 1)
    dev = q.device
    offs = torch.arange(-K, K + 1, dtype=torch.int32, device=dev)[None, :]
    in_band = (offs >= -kband[:, None]) & (offs <= kband[:, None])
    qpad = _qpad(q, K, T)
    t32 = t.to(torch.int32)
    qlen_, tlen_ = qlen[:, None], tlen[:, None]
    negf = torch.tensor(NEGF, dtype=torch.float32, device=dev)
    log_steps = int(np.ceil(np.log2(band)))

    ok0 = in_band & (offs <= qlen_)
    Sp = torch.where((offs >= 0) & ok0, float(indel) * offs.float(), negf)
    Dp = torch.full((B, band), NEGF, dtype=torch.float32, device=dev)
    planes = torch.empty((T + 1, B, band), dtype=torch.int8, device=dev)
    a0 = torch.where(offs > 0, LEFT, torch.where(offs == 0, DONE, -1))
    planes[0] = torch.where(ok0, a0, -1).to(torch.int8)
    for j in range(1, T + 1):
        qrow = qpad[:, j:j + band]
        sub = torch.where(qrow == t32[:, j - 1:j], float(m), float(mm))
        shiftS = _shift_left(Sp, NEGF)
        shiftD = _shift_left(Dp, NEGF)
        D_new = torch.maximum(shiftS + open_, shiftD)
        del_open = D_new == shiftS + open_
        sMat = Sp + sub
        delLin = shiftS + float(indel)
        base = torch.maximum(torch.maximum(sMat, delLin), D_new)
        i_vals = j + offs
        valid = (i_vals >= 1) & (i_vals <= qlen_) & (j <= tlen_) & in_band
        base = torch.where(valid, base, negf)
        L0 = base
        PM = base
        for s in range(log_steps):
            sh = 1 << s
            L0 = torch.maximum(L0, _shift_right(L0, sh, NEGF)
                               + float(indel) * sh)
            PM = torch.maximum(PM, _shift_right(PM, sh, NEGF))
        I_row = _shift_right(PM, 1, NEGF) + open_
        S_row = torch.where(valid, torch.maximum(L0, I_row), negf)
        I_row = torch.where(valid, I_row, negf)
        S_left = _shift_right(S_row, 1, NEGF)
        ins_open = I_row == S_left + open_
        arr = torch.where(
            S_row == sMat, DIAG,
            torch.where(S_row == S_left + float(indel), LEFT,
                        torch.where(S_row == delLin, DOWN,
                                    torch.where(S_row == D_new, REF_DELC,
                                                REF_INSC))))
        plane = (arr | torch.where(del_open, _DEL_OPEN_BIT, 0)
                 | torch.where(ins_open, _INS_OPEN_BIT, 0))
        planes[j] = torch.where(valid, plane, -1).to(torch.int8)
        Dp = torch.where(valid, D_new, negf)
        Sp = S_row
    return planes


def _traceback_refine_plain(planes, qlen, tlen, K, L):
    """lra_tpu _traceback_refine_device: lane-aware walk, one op per step
    -> int8 [B, L] end-first, -1 padded."""
    T1, B, band = planes.shape
    dev = planes.device
    arr_b = planes.permute(1, 0, 2)
    barange = torch.arange(B, device=dev)
    MAIN, DEL, INS = 0, 1, 2
    i = qlen.to(torch.int64)
    j = tlen.to(torch.int64)
    lane = torch.zeros(B, dtype=torch.int64, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    ops = torch.full((B, L), -1, dtype=torch.int8, device=dev)
    m1 = torch.full((B,), -1, dtype=torch.int64, device=dev)
    for s in range(L):
        if s % 64 == 0 and not bool(active.any()):
            break
        d = i - j + K
        ok = active & (i >= 0) & (j >= 0) & (d >= 0) & (d < band)
        p = arr_b[barange, j.clamp(0, T1 - 1),
                  d.clamp(0, band - 1)].to(torch.int64)
        code = p & 7
        rail = (p < 0) | ~ok
        dopen = (p & _DEL_OPEN_BIT) != 0
        iopen = (p & _INS_OPEN_BIT) != 0
        act_del = ((lane == DEL) | ((lane == MAIN) & (code == REF_DELC))) \
            & ~rail
        act_ins = ((lane == INS) | ((lane == MAIN) & (code == REF_INSC))) \
            & ~rail
        plain = (lane == MAIN) & ~rail & (code != REF_DELC) & \
            (code != REF_INSC) & (code != DONE)
        a = torch.where(act_del, DOWN,
                        torch.where(act_ins, LEFT,
                                    torch.where(plain, code, m1)))
        lane = torch.where(
            act_del, torch.where(dopen, MAIN, DEL),
            torch.where(act_ins, torch.where(iopen, MAIN, INS), MAIN))
        i = i - ((a == DIAG) | (a == LEFT)).to(torch.int64)
        j = j - ((a == DIAG) | (a == DOWN)).to(torch.int64)
        active = a >= 0
        ops[:, s] = a.to(torch.int8)
    return ops


def banded_refine_traced_packed_plain(q, t, qlen, tlen, K, m, mm, indel,
                                      kband):
    planes = refine_planes_plain(q, t, qlen, tlen, K, m, mm, indel, kband)
    L = q.shape[1] + t.shape[1]
    return _pack_ops(_traceback_refine_plain(planes, qlen, tlen, K, L))


def banded_refine_traced_packed(q, t, qlen, tlen, K, m, mm, indel,
                                kband=None):
    """Refine DP + lane-aware device traceback, packed like
    banded_global_traced_packed (shared unpack/blocks path)."""
    if (q.shape[1] + t.shape[1]) % 4:
        raise ValueError("packed traceback requires Q+T to be a multiple "
                         "of 4")
    kband = _kband_or_full(kband, q.shape[0], K, q.device)
    if q.device.type == "cuda":
        return _banded_cuda("banded_refine_traced_packed", "banded_refine",
                            "lra_banded_refine_traced_packed", q, t, qlen,
                            tlen, kband, K, m, mm, indel)
    return banded_refine_traced_packed_plain(q, t, qlen, tlen, K, m, mm,
                                             indel, kband)


def banded_refine_np(q, t, qlen, tlen, K, m, mm, indel, kband):
    """Numpy mirror of _refine_arrows (host fallback; identical
    recurrence and tie order)."""
    B, Q = q.shape
    T = t.shape[1]
    band = 2 * K + 1
    open_ = 2 * indel + 1
    offs = np.arange(-K, K + 1, dtype=np.int64)
    in_band = (offs[None, :] >= -kband[:, None]) & \
              (offs[None, :] <= kband[:, None])
    NEGF_ = np.float32(-1.0e30)

    qpad = np.full((B, Q + 2 * K + T + 2), 5, np.int32)
    qpad[:, K + 1:K + 1 + Q] = q

    Sp = np.where((offs[None, :] >= 0) & in_band
                  & (offs[None, :] <= qlen[:, None]),
                  indel * offs[None, :].astype(np.float32), NEGF_)
    planes = np.full((B, T + 1, band), -1, np.int8)
    planes[:, 0] = np.where(offs[None, :] > 0, LEFT,
                            np.where(offs[None, :] == 0, DONE, -1))
    planes[:, 0][~(in_band & (offs[None, :] <= qlen[:, None]))] = -1

    log_steps = int(np.ceil(np.log2(band)))
    rows_all = np.full((B, T + 1, band), NEGF_, np.float32)
    rows_all[:, 0] = Sp
    Dp = np.full((B, band), NEGF_, np.float32)
    for j in range(1, T + 1):
        qrow = qpad[:, j:j + band]
        sub = np.where(qrow == t[:, j - 1][:, None], float(m), float(mm))
        shiftS = np.concatenate([Sp[:, 1:], np.full((B, 1), NEGF_)], axis=1)
        shiftD = np.concatenate([Dp[:, 1:], np.full((B, 1), NEGF_)], axis=1)
        D_new = np.maximum(shiftS + float(open_), shiftD)
        del_open = D_new == shiftS + float(open_)
        sMat = Sp + sub
        delLin = shiftS + float(indel)
        base = np.maximum(np.maximum(sMat, delLin), D_new)
        i_vals = j + offs[None, :]
        valid = (i_vals >= 1) & (i_vals <= qlen[:, None]) & \
                (j <= tlen[:, None]) & in_band
        base = np.where(valid, base, NEGF_)
        L0 = base
        PM = base
        for s in range(log_steps):
            sh = 1 << s
            L0 = np.maximum(L0, np.concatenate(
                [np.full((B, sh), NEGF_), L0[:, :-sh]], axis=1)
                + float(indel) * sh)
            PM = np.maximum(PM, np.concatenate(
                [np.full((B, sh), NEGF_), PM[:, :-sh]], axis=1))
        I_row = np.concatenate(
            [np.full((B, 1), NEGF_), PM[:, :-1]], axis=1) + float(open_)
        S_row = np.where(valid, np.maximum(L0, I_row), NEGF_)
        I_row = np.where(valid, I_row, NEGF_)
        S_left = np.concatenate([np.full((B, 1), NEGF_), S_row[:, :-1]],
                                axis=1)
        ins_open = I_row == S_left + float(open_)
        arr = np.where(
            S_row == sMat, DIAG,
            np.where(S_row == S_left + float(indel), LEFT,
                     np.where(S_row == delLin, DOWN,
                              np.where(S_row == D_new, REF_DELC,
                                       REF_INSC)))).astype(np.int8)
        plane = (arr | np.where(del_open, _DEL_OPEN_BIT, 0)
                 | np.where(ins_open, _INS_OPEN_BIT, 0)).astype(np.int8)
        planes[:, j] = np.where(valid, plane, np.int8(-1))
        Dp = np.where(valid, D_new, NEGF_).astype(np.float32)
        Sp = S_row.astype(np.float32)
        rows_all[:, j] = S_row
    d_final = (qlen - tlen + K).astype(np.int64)
    score = rows_all[np.arange(B), tlen, d_final]
    return score, planes


def traceback_refine(planes: np.ndarray, qlen: int, tlen: int, K: int):
    """Host lane-aware traceback of one problem's refine plane
    [T+1, band].  Returns blocks [(q_off, t_off, len)]."""
    i, j = int(qlen), int(tlen)
    lane = 0    # 0 main, 1 del, 2 ins
    ops: list = []
    band = planes.shape[1]
    while i >= 0 and j >= 0:
        d = i - j + K
        if d < 0 or d >= band:
            break
        p = int(planes[j, d])
        if p < 0:
            break
        code = p & 7
        if lane == 1 or (lane == 0 and code == REF_DELC):
            ops.append(DOWN)
            lane = 0 if (p & _DEL_OPEN_BIT) else 1
            j -= 1
        elif lane == 2 or (lane == 0 and code == REF_INSC):
            ops.append(LEFT)
            lane = 0 if (p & _INS_OPEN_BIT) else 2
            i -= 1
        elif code == DONE:
            break
        elif code == DIAG:
            ops.append(DIAG)
            i -= 1
            j -= 1
        elif code == LEFT:
            ops.append(LEFT)
            i -= 1
        elif code == DOWN:
            ops.append(DOWN)
            j -= 1
        else:
            break
    blocks = []
    qPos = tPos = 0
    run = 0
    for op in ops[::-1]:
        if op == DIAG:
            run += 1
            qPos += 1
            tPos += 1
        else:
            if run:
                blocks.append((qPos - run, tPos - run, run))
                run = 0
            if op == LEFT:
                qPos += 1
            else:
                tPos += 1
    if run:
        blocks.append((qPos - run, tPos - run, run))
    return blocks


def banded_global_np(q, t, qlen, tlen, K, m, mm, indel, kband):
    """Batched numpy mirror of banded_global_kernel (identical recurrence,
    used as the host fallback so CPU-only runs get the same batching).

    q: int8[B,Q], t: int8[B,T], qlen/tlen/kband: int[B].
    Returns (score f32[B], arrows int8[B, T+1, 2K+1]).
    """
    B, Q = q.shape
    T = t.shape[1]
    band = 2 * K + 1
    offs = np.arange(-K, K + 1, dtype=np.int64)
    in_band = (offs[None, :] >= -kband[:, None]) & \
              (offs[None, :] <= kband[:, None])
    NEGF = np.float32(-1.0e30)

    qpad = np.full((B, Q + 2 * K + T + 2), 5, np.int32)
    qpad[:, K + 1:K + 1 + Q] = q

    row = np.where((offs[None, :] >= 0) & in_band,
                   indel * offs[None, :].astype(np.float32), NEGF)
    arrows = np.full((B, T + 1, band), -1, np.int8)
    arrows[:, 0] = np.where(offs[None, :] > 0, LEFT,
                            np.where(offs[None, :] == 0, DONE, -1))
    arrows[:, 0][~in_band] = -1

    log_steps = int(np.ceil(np.log2(band)))
    rows_all = np.full((B, T + 1, band), NEGF, np.float32)
    rows_all[:, 0] = row
    for j in range(1, T + 1):
        prev = row
        qrow = qpad[:, j:j + band]
        sub = np.where(qrow == t[:, j - 1][:, None], float(m), float(mm))
        sMat = prev + sub
        prev_shift = np.concatenate(
            [prev[:, 1:], np.full((B, 1), NEGF)], axis=1)
        sDel = prev_shift + float(indel)
        base = np.maximum(sMat, sDel)
        i_vals = j + offs[None, :]
        is_i0 = i_vals == 0
        base = np.where(is_i0, float(indel) * j, base)
        valid = (i_vals >= 0) & (i_vals <= qlen[:, None]) & \
                (j <= tlen[:, None]) & in_band
        base = np.where(valid, base, NEGF)
        row = base
        for s in range(log_steps):
            sh = 1 << s
            shifted = np.concatenate(
                [np.full((B, sh), NEGF), row[:, :-sh]], axis=1)
            row = np.maximum(row, shifted + float(indel) * sh)
        row = np.where(valid, row, NEGF)
        row_left = np.concatenate([np.full((B, 1), NEGF), row[:, :-1]],
                                  axis=1)
        arr = np.where(row == row_left + float(indel), LEFT,
                       np.where(row == sDel, DOWN, DIAG)).astype(np.int8)
        arr = np.where(is_i0, np.int8(DOWN), arr)
        arr = np.where(valid, arr, np.int8(-1))
        arrows[:, j] = arr
        rows_all[:, j] = row
    d_final = (qlen - tlen + K).astype(np.int64)
    score = rows_all[np.arange(B), tlen, d_final]
    return score, arrows
