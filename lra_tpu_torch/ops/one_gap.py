"""One-long-gap banded aligner (K6).

Batched DP for the separated prefix/suffix band regime of the
reference's ``AffineOneGapAlign`` (reference: AffineOneGapAlign.h:157,
194-201): when |qLen - tLen| > 2k the alignment is a k-banded prefix
matrix from (0,0), a k-banded suffix matrix anchored at (qLen,tLen), and
ONE free arbitrarily-long gap joining them (a column-max closure when
the query is longer, a row-max closure when the target is longer).

``one_gap_traced`` launches the CUDA kernel (csrc/one_gap.cu, with the
launch plan of ``one_gap_plan``) for CUDA tensors and runs
``one_gap_traced_plain`` for CPU tensors.  Both are
bit-identical to lra_tpu's jitted one_gap_traced and through it to the
host oracle ``align.affine.affine_one_gap_align`` (same integer scores,
same tie order LEFT > DOWN > DIAG > GAPLEFT > GAPDOWN, same
>=-latest / >-earliest closure argmax conventions, same border seeding)
— enforced by tests/test_one_gap.py fuzzing.

Data layout per (K, D) bucket: lanes are band offsets.  Prefix lanes
d = i - j + K (width 2K+1).  Suffix lanes e = i - j - (qlen - tlen) + K
extended two lanes down and one up (width 2K+4, index e + 2) to carry
the reference's border-seed rails.  Scans run over the target axis j;
per-problem offsets (tLow) are absorbed by pre-shifting the input code
planes with one gather so the scan body stays uniform.

The free gap spans the middle of the longer sequence, which the DP
never reads — inputs are therefore COMPACTED to a head window (first
D+K codes, feeding the prefix band) and a tail window (last D+K+4
codes, feeding the suffix band).  Bucket shapes depend only on (K, D),
never on the gap length: a 50kb SV gap costs the same as a 200bp one.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _ext

# op codes shared with align.affine
DONE, LEFT, DOWN, DIAG, BORDER, GAPLEFT, GAPDOWN = range(7)

NEGF = np.float32(-1e9)


def _t(x, dev, dtype=torch.int32):
    return torch.as_tensor(x, dtype=dtype, device=dev)


def _shl(x, fill):
    """x[:, e+1] at e, `fill` at the last column."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def _shr(x, sh, fill):
    """x[:, e-sh] at e, `fill` in the first sh columns."""
    return torch.cat([torch.full_like(x[:, :sh], fill), x[:, :-sh]], dim=1)


def _closure_left(row, width, indel):
    """row[e] = max_{e' <= e} row[e'] + indel * (e - e')  (the in-column
    insertion chain, linear gap => log-step max-plus closure; the same
    doubling order as the reference, since NEGF = -1e9 is not absorbing
    in f32)."""
    log_steps = int(np.ceil(np.log2(max(2, width))))
    for s in range(log_steps):
        sh = 1 << s
        row = torch.maximum(row, _shr(row, sh, float(NEGF))
                            + float(indel) * sh)
    return row


def _take(a, idx):
    return torch.gather(a, 1, idx.to(torch.int64))


def _prefix_pass(q, qlen, tlen, kband, K, D, m, mm, indel, t):
    """Banded prefix DP from (0,0).

    Returns (arrows [TP+1, B, 2K+1], lower_max/lower_idx [B, TP+1] per
    column j, upper_max/upper_idx [B, UP] per row i, padded by K)."""
    B = q.shape[0]
    dev = q.device
    LP = 2 * K + 1
    TPs = D + K - 1          # rows j = 1 .. TPs
    negf = float(NEGF)
    offs = torch.arange(-K, K + 1, dtype=torch.int32, device=dev)
    in_band = offs.abs()[None, :] <= kband[:, None]
    diag = torch.minimum(qlen, tlen)
    qB1 = torch.minimum(diag + kband - 1, qlen)   # qBoundary - 1
    tB1 = torch.minimum(diag + kband - 1, tlen)   # tBoundary - 1

    # row j=0: P[i,0] = indel*i for 0 <= i <= kband
    row = torch.where((offs[None, :] >= 0) & in_band,
                      float(indel) * offs[None, :].float(), negf)
    a0 = torch.where(offs[None, :] > 0, LEFT,
                     torch.where(offs[None, :] == 0, DONE, -1))
    arrows = [torch.where(in_band & (offs[None, :] <= qB1[:, None]), a0,
                          -1).to(torch.int8)]
    row = torch.where(offs[None, :] <= qB1[:, None], row, negf)

    qpad = torch.full((B, q.shape[1] + 2 * K + TPs + 3), 9,
                      dtype=torch.int32, device=dev)
    qpad[:, K + 1:K + 1 + q.shape[1]] = q.to(torch.int32)
    t32 = t.to(torch.int32)

    UP = D + 3 * K + 4       # upper arrays padded: row i at index i + K
    up = torch.full((B, UP), negf, dtype=torch.float32, device=dev)
    upi = torch.zeros((B, UP), dtype=torch.int32, device=dev)
    # init upperMax[0] = 0 (idx 0) when qlen <= tlen
    up[:, K] = torch.where(qlen <= tlen, 0.0, negf)

    lmax = [torch.where(qlen >= tlen, 0.0, negf)]
    lidx = [torch.zeros(B, dtype=torch.int32, device=dev)]
    for j in range(1, TPs + 1):
        prev = row
        qrow = qpad[:, j:j + LP]
        tj = t32[:, min(j - 1, t.shape[1] - 1)]
        sub = torch.where(qrow == tj[:, None], float(m), float(mm))
        i_vals = (j + offs)[None, :].expand(B, LP)

        sMat = prev + sub
        sDel = _shl(prev, negf) + float(indel)
        base = torch.maximum(sMat, sDel)
        # main-loop cell range: 1 <= i <= qB1, j <= tB1, |i-j| <= kband
        valid = (i_vals >= 1) & (i_vals <= qB1[:, None]) & \
            (j <= tB1[:, None]) & in_band
        # i=0 rail: P[0,j] = indel*j for j <= kband+1, injected into the
        # i=1 cell
        rail_ins = torch.where(
            (i_vals == 1) & (j <= kband[:, None] + 1) & valid,
            float(indel) * (j + 1), negf)
        base = torch.maximum(base, rail_ins)
        base = torch.where(valid, base, negf)

        row = _closure_left(base, LP, indel)
        row = torch.where(valid, row, negf)
        is_i0 = (i_vals == 0) & in_band & (j <= tB1[:, None])
        row = torch.where(is_i0, float(indel) * j, row)

        row_left = _shr(row, 1, negf)
        is_ins = (row == row_left + float(indel)) | (row == rail_ins)
        arr = torch.where(is_ins, LEFT, torch.where(row == sDel, DOWN, DIAG))
        arr = torch.where(is_i0, DOWN, arr)
        arrows.append(torch.where(valid | is_i0, arr, -1).to(torch.int8))

        # lowerMax[j]: last (largest-i) max over main cells with
        # i < qlen - kband
        lm_ok = valid & (i_vals < qlen[:, None] - kband[:, None]) & \
            (j <= diag[:, None])
        lm_vals = torch.where(lm_ok, row, negf)
        amax = LP - 1 - lm_vals.flip(1).argmax(dim=1)
        lmax.append(lm_vals.amax(dim=1))
        lidx.append((j + offs[amax]).to(torch.int32))

        # upperMax[i] strict >, earliest j wins: window update at rows
        # i = j + offs (padded index i + K => window start j)
        um_ok = valid & (i_vals <= diag[:, None]) & (j < tlen[:, None])
        cand = torch.where(um_ok, row, negf)
        win = up[:, j:j + LP]
        wini = upi[:, j:j + LP]
        upd = cand > win
        up[:, j:j + LP] = torch.where(upd, cand, win)
        upi[:, j:j + LP] = torch.where(upd, j, wini).to(torch.int32)
    return (torch.stack(arrows), torch.stack(lmax, 1),
            torch.stack(lidx, 1), up, upi)


def _suffix_pass(q_tail, t_tail, qlen, tlen, kband, K, D, m, mm, indel,
                 lmax, up):
    """Banded suffix DP anchored at (qlen, tlen) with free-gap closures.

    q_tail/t_tail: [B, HS] with HS = D+K+4, tail[b, z] =
    seq[b, len - HS + z].  Lanes e_idx = i - j - (qlen - tlen) + K + 2,
    width 2K+4.  Returns (arrows [TSs+1, B, 2K+4], score [B])."""
    B = q_tail.shape[0]
    dev = q_tail.device
    negf = float(NEGF)
    LS = 2 * K + 4
    HS = D + K + 4
    TSs = D + K + 2          # s = 0 .. TSs-1, j = tLow + 1 + s
    diag = torch.minimum(qlen, tlen)
    isA = qlen > tlen
    dqt = qlen - tlen
    qStart = qlen - diag
    tStart = tlen - diag
    tLow = torch.clamp(tlen - diag - kband - 2, min=0)
    qLow = torch.clamp(qlen - diag - kband - 1, min=0)
    eoffs = torch.arange(LS, dtype=torch.int32, device=dev) - (K + 2)

    # pre-shift gathers (the reference's take_along_axis windows)
    sidx = torch.arange(TSs, dtype=torch.int32, device=dev)
    PAD = 9
    tpadded = torch.cat([t_tail.to(torch.int32),
                         torch.full((B, TSs + 2), PAD, dtype=torch.int32,
                                    device=dev)], dim=1)
    tzoff = tLow - tlen + HS
    tsh = _take(tpadded, (tzoff[:, None] + sidx[None, :])
                .clamp(0, tpadded.shape[1] - 1))
    uidx = torch.arange(TSs + LS, dtype=torch.int32, device=dev)
    qpadded = torch.cat([
        torch.full((B, HS + LS + 4), PAD, dtype=torch.int32, device=dev),
        q_tail.to(torch.int32),
        torch.full((B, TSs + LS + 4), PAD, dtype=torch.int32, device=dev)],
        dim=1)
    qzoff = tLow - tlen - K - 2 + HS + (HS + LS + 4)
    qsh = _take(qpadded, (qzoff[:, None] + uidx[None, :])
                .clamp(0, qpadded.shape[1] - 1))
    TPcols = lmax.shape[1]
    lmpad = torch.cat([lmax, torch.full((B, TSs + 2), negf, device=dev)], 1)
    lmsh = _take(lmpad, (tLow[:, None] + 1 + sidx[None, :])
                 .clamp(0, lmpad.shape[1] - 1))
    lm_at_tlow = _take(lmax, tLow[:, None].clamp(0, TPcols - 1))[:, 0]
    uppad = torch.cat([up, torch.full((B, TSs + LS + 2), negf,
                                      device=dev)], 1)
    uoff2 = tLow + 1 + dqt - 2
    upsh = _take(uppad, (uoff2[:, None] + uidx[None, :])
                 .clamp(0, uppad.shape[1] - 1))
    ubidx = tLow + 1 - tStart + kband + 1 + K
    ubsh = _take(uppad, (ubidx[:, None] + sidx[None, :])
                 .clamp(0, uppad.shape[1] - 1))

    # carry init, column j = tLow
    i0_vals = tLow[:, None] + dqt[:, None] + eoffs[None, :]
    bA = isA[:, None] & (i0_vals >= qLow[:, None]) & \
        (i0_vals <= qStart[:, None] + kband[:, None])
    bB = (~isA[:, None]) & (i0_vals == 0)
    upK = up[:, K][:, None]
    row = torch.where(bA, lm_at_tlow[:, None],
                      torch.where(bB, upK, negf))
    arrows = [torch.where(bA, GAPLEFT,
                          torch.where(bB, GAPDOWN, -1)).to(torch.int8)]

    eA_idx = qLow - 1 - dqt + K + 2       # case A border-b lane index
    eB_idx = K + kband + 3                # case B border-b' lane index
    e_ok = eoffs.abs()[None, :] <= kband[:, None]
    tB_hi = torch.minimum(tStart + kband + 1, tlen)
    acc = torch.full((B,), negf, dtype=torch.float32, device=dev)
    for s in range(TSs):
        prev = row
        j = tLow + 1 + s                                  # [B]
        i_vals = j[:, None] + dqt[:, None] + eoffs[None, :]
        tcode = tsh[:, s:s + 1]
        qcode = qsh[:, s:s + LS]
        sub = torch.where(qcode == tcode, float(m), float(mm))

        sMat = prev + sub
        sDel = _shl(prev, negf) + float(indel)

        valid = e_ok & (i_vals >= qLow[:, None] + 1) & \
            (i_vals <= qlen[:, None]) & (j[:, None] <= tlen[:, None])
        delC = torch.where(
            isA[:, None] & (j[:, None] <= diag[:, None]) & valid,
            lmsh[:, s:s + 1], negf)
        insC = torch.where(
            (~isA[:, None]) & (i_vals <= diag[:, None]) & valid,
            upsh[:, s:s + LS], negf)

        base = torch.maximum(torch.maximum(sMat, sDel),
                             torch.maximum(delC, insC))
        base = torch.where(valid, base, negf)

        # border seeds of this column, injected before the closure
        bAcell = isA[:, None] & \
            (eoffs[None, :] + K + 2 == eA_idx[:, None]) & \
            (j[:, None] <= diag[:, None]) & \
            (i_vals >= 0) & (i_vals <= qlen[:, None]) & \
            (j[:, None] <= tlen[:, None])
        bBcell = (~isA[:, None]) & (i_vals == 0) & \
            (j[:, None] >= tLow[:, None]) & (j[:, None] <= tB_hi[:, None])
        i_b = j - tStart + kband + 1
        bB2cell = (~isA[:, None]) & \
            (eoffs[None, :] + K + 2 == eB_idx[:, None]) & \
            (i_b[:, None] >= 1) & (i_b[:, None] <= diag[:, None]) & \
            (i_vals <= qlen[:, None]) & (j[:, None] <= tlen[:, None])
        bval = torch.where(
            bAcell, lmsh[:, s:s + 1],
            torch.where(bBcell, upK,
                        torch.where(bB2cell, ubsh[:, s:s + 1], negf)))
        seed = (bAcell | bBcell | bB2cell) & ~valid
        base = torch.where(seed, bval, base)

        row = _closure_left(base, LS, indel)
        row = torch.where(valid | seed, row, negf)
        # seed cells keep the pure seed (the reference assigns, never
        # maxes, at seed cells)
        row = torch.where(seed, bval, row)

        row_left = _shr(row, 1, negf)
        arr = torch.where(
            row == row_left + float(indel), LEFT,
            torch.where(row == sDel, DOWN,
                        torch.where(row == sMat, DIAG,
                                    torch.where(row == delC, GAPLEFT,
                                                GAPDOWN))))
        arr = torch.where(seed, torch.where(bAcell, GAPLEFT, GAPDOWN), arr)
        arrows.append(torch.where(valid | seed, arr, -1).to(torch.int8))
        acc = torch.where(j == tlen, row[:, K + 2], acc)
    return torch.stack(arrows), acc


def _traceback(parr, sarr, qlen, tlen, kband, K, lidx, upi, L):
    """Traceback: suffix walk -> gap jump -> prefix walk.

    Returns (ops int8 [B, L] end-first, -1 padded; jump_len int32 [B];
    the single GAPLEFT/GAPDOWN op in the stream marks where the free
    gap sits)."""
    B = qlen.shape[0]
    dev = qlen.device
    diag = torch.minimum(qlen, tlen).to(torch.int64)
    dqt = (qlen - tlen).to(torch.int64)
    tLow = torch.clamp(tlen.to(torch.int64) - diag - kband - 2, min=0)
    barange = torch.arange(B, device=dev)
    pa = parr.permute(1, 0, 2)
    sa = sarr.permute(1, 0, 2)
    TP1 = pa.shape[1]
    TS1 = sa.shape[1]
    UPW = upi.shape[1]
    lidx64 = lidx.to(torch.int64)
    upi64 = upi.to(torch.int64)
    i = qlen.to(torch.int64)
    j = tlen.to(torch.int64)
    phase = torch.zeros(B, dtype=torch.int64, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    jump = torch.zeros(B, dtype=torch.int64, device=dev)
    ops = torch.full((B, L), -1, dtype=torch.int8, device=dev)
    for step in range(L):
        if step % 64 == 0 and not bool(active.any()):
            break
        srow = (j - tLow).clamp(0, TS1 - 1)
        slane = (i - j - dqt + K + 2).clamp(0, 2 * K + 3)
        prow = j.clamp(0, TP1 - 1)
        plane = (i - j + K).clamp(0, 2 * K)
        a = torch.where(phase == 0, sa[barange, srow, slane],
                        pa[barange, prow, plane]).to(torch.int64)
        ok = active & (i >= 0) & (j >= 0) & (a >= 0) & (a != DONE)
        a = torch.where(ok, a, -1)
        is_gl = a == GAPLEFT
        is_gd = a == GAPDOWN
        land_i = lidx64[barange, j.clamp(0, lidx.shape[1] - 1)]
        land_j = upi64[barange, (i + K).clamp(0, UPW - 1)]
        jump = torch.where(is_gl, i - land_i,
                           torch.where(is_gd, j - land_j, jump))
        i2 = torch.where(is_gl, land_i,
                         torch.where((a == DIAG) | (a == LEFT), i - 1, i))
        j2 = torch.where(is_gd, land_j,
                         torch.where((a == DIAG) | (a == DOWN), j - 1, j))
        phase = torch.where(is_gl | is_gd, 1, phase)
        i, j = i2, j2
        active = a >= 0
        ops[:, step] = a.to(torch.int8)
    return ops, jump.to(torch.int32)


HEAD = lambda K, D: D + K            # head window width
TAIL = lambda K, D: D + K + 4        # tail window width


def one_gap_traced(q_head, t_head, q_tail, t_tail, qlen, tlen, kband,
                   K, D, m, mm, indel, L):
    """Batched one-long-gap alignment with traceback.

    q_head/t_head: int32[B, D+K] (codes from position 0), q_tail/t_tail:
    int32[B, D+K+4] (tail[z] = seq[len - (D+K+4) + z]), qlen/tlen/kband:
    int32[B] with kband <= K, min(qlen,tlen) <= D, and the one-gap
    regime min + 2*kband < max for every problem.

    Returns (ops int8[B, L] end-first with codes LEFT/DOWN/DIAG/
    GAPLEFT/GAPDOWN and -1 padding, jump_len int32[B], score f32[B])."""
    if q_head.device.type == "cuda":
        return _one_gap_traced_cuda(q_head, t_head, q_tail, t_tail, qlen,
                                    tlen, kband, K, D, m, mm, indel, L)
    return one_gap_traced_plain(q_head, t_head, q_tail, t_tail, qlen, tlen,
                                kband, K, D, m, mm, indel, L)


def one_gap_traced_plain(q_head, t_head, q_tail, t_tail, qlen, tlen, kband,
                         K, D, m, mm, indel, L):
    """Plain torch version (any device): python loops over the DP rows
    and the traceback steps."""
    parr, lmax, lidx, up, upi = _prefix_pass(
        q_head, qlen, tlen, kband, K, D, m, mm, indel, t_head)
    sarr, score = _suffix_pass(q_tail, t_tail, qlen, tlen, kband, K, D, m,
                               mm, indel, lmax, up)
    ops, jump = _traceback(parr, sarr, qlen, tlen, kband, K, lidx, upi, L)
    return ops, jump, score


_OG_PLAN_KEYS = ("tier", "CPT", "WPP", "PPB", "threads", "smem",
                 "tables_smem", "planes_smem", "R", "scratch")
_ONE_GAP_ARGS = [ctypes.c_void_p] * 11 + \
    [ctypes.c_int] * (7 + len(_OG_PLAN_KEYS))
_OG_R = 64          # plane rows a staged chunk of the walk holds
_OG_RING = 8        # suffix rows in the ring to the arrows warp
_OG_PPB = 4         # problems a block when a bucket fills the card
_OG_FULL_WARPS = 16     # warps a SM past which a bucket fills the card
SMEM_MAX = _ext.SMEM_MAX


def _a16(x: int) -> int:
    return (x + 15) & ~15


def _og_group_bytes(K: int, D: int, L: int, tables_smem: bool,
                    planes_smem: bool, R: int) -> tuple:
    """(shared bytes, device table bytes, device plane bytes) of one
    problem in the warp tier: csrc/one_gap.cu's og_layout.  Shared: the
    progress words, the four windows as bytes, the ops row, the ring of
    _OG_RING suffix rows (32 lanes of 2 or 3 f32 cells), then the gap
    tables (lmax/lidx [D+K], up/upi [D+3K+4], 4 bytes each) and the two
    arrow planes ([D+K] and [D+K+3] rows of 2K+4 bytes) where they fit,
    else two staging chunks of R plane rows for the walk."""
    HP, HS, TP1, TS1 = D + K, D + K + 4, D + K, D + K + 3
    UP, PW = D + 3 * K + 4, 2 * K + 4
    group = 16 + 2 * _a16(HP) + 2 * _a16(HS) + _a16(L) + \
        _OG_RING * 32 * (2 if K == 16 else 3) * 4
    tables = 2 * _a16(4 * TP1) + 2 * _a16(4 * UP)
    planes = _a16(TP1 * PW) + _a16(TS1 * PW)
    group += tables if tables_smem else 0
    group += planes if planes_smem else 2 * _a16(R * PW + 32)
    return (group, 0 if tables_smem else tables,
            0 if planes_smem else planes)


def _og_cta_scratch(B: int, K: int, D: int) -> int:
    """Device bytes of the CTA tier's planes and tables (csrc/one_gap.cu's
    cta_scratch)."""
    TP1, TS1, UP = D + K, D + K + 3, D + 3 * K + 4
    return sum(_a16(n) for n in (B * TP1 * (2 * K + 1),
                                 B * TS1 * (2 * K + 4), 4 * B * TP1,
                                 4 * B * TP1, 4 * B * UP, 4 * B * UP))


def _warp_plan(K, D, B, L, wpp, ppb, tables, planes) -> dict:
    group, tb, pb = _og_group_bytes(K, D, L, tables, planes, _OG_R)
    return {"tier": 0, "CPT": 2 if K == 16 else 3, "WPP": wpp, "PPB": ppb,
            "threads": 32 * wpp * ppb, "smem": ppb * group,
            "tables_smem": int(tables), "planes_smem": int(planes),
            "R": _OG_R, "scratch": B * (tb + pb)}


def one_gap_plan(K: int, D: int, B: int = 1, sms: int = 132,
                 L: int | None = None) -> dict:
    """Launch plan of csrc/one_gap.cu for a (K, D) bucket of B problems
    (ops rows of L bytes, 2(D+K)+8 by default) on a card of `sms` SMs.

    K = 16 and 32 (every launch on the pipeline's paths) take the warp
    tier (tier 0): a problem's band rows in one warp, CPT = 2 or 3 cells
    a lane.  A bucket that leaves the card idle (3B warps at most
    _OG_FULL_WARPS a SM) runs WPP = 3 warps a problem, one problem a
    block: the prefix, the suffix DP beside it, and the suffix's arrows;
    a fuller one one warp a problem and PPB = 4 problems a block (2 or 1
    where 4 do not fit).  The gap tables, then the arrow planes, stay in
    shared memory while one problem's bytes fit in SMEM_MAX; what does not
    fit goes to device scratch (`scratch` bytes), and a walk over device
    planes stages chunks of R rows.  Other K take the CTA tier (tier 1):
    one CTA a problem, CPT = 1, 2 or 4 band cells a thread, planes and
    tables in device scratch.  Raises where no plan fits."""
    L = 2 * (D + K) + 8 if L is None else L
    if K in (16, 32):
        full = 3 * B > _OG_FULL_WARPS * sms
        for tables, planes in ((True, True), (True, False), (False, False)):
            group = _og_group_bytes(K, D, L, tables, planes, _OG_R)[0]
            ppb = next((n for n in ((_OG_PPB, 2, 1) if full else (1,))
                        if n * group <= SMEM_MAX), 0)
            if ppb:
                return _warp_plan(K, D, B, L, 1 if full else 3, ppb, tables,
                                  planes)
        raise ValueError(f"one_gap_traced kernel: no plan fits K={K} D={D} "
                         f"in {SMEM_MAX} bytes of shared memory")
    LS = 2 * K + 4
    if LS > 4096:
        raise ValueError(f"one_gap_traced kernel: needs 2K+4 <= 4096 "
                         f"(got K={K})")
    cpt = 1 if LS <= 1024 else (2 if LS <= 2048 else 4)
    threads = ((LS + cpt - 1) // cpt + 31) // 32 * 32
    return {"tier": 1, "CPT": cpt, "WPP": threads // 32, "PPB": 1,
            "threads": threads, "smem": (3 * LS + 1) * 4, "tables_smem": 0,
            "planes_smem": 0, "R": 0, "scratch": _og_cta_scratch(B, K, D)}


def plan_variants(K: int, D: int, B: int) -> list:
    """The plans a (K, D) bucket of B problems can run with, by name:
    one_gap_plan's, and in the warp tier the other warps-a-problem shape
    (one warp with 4 problems a block, or three) and, with three warps,
    the planes, then the tables too, in device memory, where one
    problem's shared bytes fit."""
    chosen = one_gap_plan(K, D, B)
    out = [("plan", chosen)]
    if chosen["tier"] != 0:
        return out
    L = 2 * (D + K) + 8
    t, pl = chosen["tables_smem"], chosen["planes_smem"]
    for name, plan in (
            ("one warp a problem", _warp_plan(K, D, B, L, 1, 1, t, pl)),
            ("three warps a problem", _warp_plan(K, D, B, L, 3, 1, t, pl)),
            ("planes in device memory",
             _warp_plan(K, D, B, L, 3, 1, t, False)),
            ("tables and planes in device memory",
             _warp_plan(K, D, B, L, 3, 1, False, False))):
        if plan["smem"] <= SMEM_MAX and all(plan != q for _, q in out):
            out.append((name, plan))
    return out


def plan_str(plan) -> str:
    return ("tier {tier} CPT {CPT} WPP {WPP} PPB {PPB} smem {smem} tables "
            "{tables_smem} planes {planes_smem} scratch {scratch}"
            .format(**plan))


@functools.lru_cache(maxsize=None)
def _plan_args(K: int, D: int, B: int, sms: int, L: int) -> tuple:
    plan = one_gap_plan(K, D, B, sms, L)
    return tuple(plan[k] for k in _OG_PLAN_KEYS)


def _one_gap_traced_cuda(q_head, t_head, q_tail, t_tail, qlen, tlen, kband,
                         K, D, m, mm, indel, L, plan=None):
    """K6 on the card with one_gap_plan's plan (or the one given): one
    allocation for the three outputs, one for the scratch the plan puts
    in device memory."""
    B = q_head.shape[0]
    HP, HS = HEAD(K, D), TAIL(K, D)
    for name, t, w in (("q_head", q_head, HP), ("t_head", t_head, HP),
                       ("q_tail", q_tail, HS), ("t_tail", t_tail, HS)):
        _ext.check(name, t, torch.int32, (B, w))
    for name, t in (("qlen", qlen), ("tlen", tlen), ("kband", kband)):
        _ext.check(name, t, torch.int32, (B,))
    dev = q_head.device
    nb = _a16(B * L)
    out = torch.empty(nb + 8 * B, dtype=torch.uint8, device=dev)
    ops = out[:B * L].view(torch.int8).view(B, L)
    jump = out[nb:nb + 4 * B].view(torch.int32)
    score = out[nb + 4 * B:].view(torch.float32)
    if B == 0:
        return ops, jump, score
    args = (_plan_args(K, D, B, _ext.sm_count(dev.index or 0), L)
            if plan is None else tuple(plan[k] for k in _OG_PLAN_KEYS))
    scratch = torch.empty(args[-1], dtype=torch.uint8, device=dev) \
        if args[-1] else None
    p = _ext.ptr
    _ext.launch("one_gap_traced", "one_gap", "lra_one_gap_traced",
                _ONE_GAP_ARGS, p(q_head), p(t_head), p(q_tail), p(t_tail),
                p(qlen), p(tlen), p(kband),
                0 if scratch is None else p(scratch), p(ops), p(jump),
                p(score), B, K, D, int(m), int(mm), int(indel), L, *args)
    return ops, jump, score


def pack_one_gap_bucket(qs: list, ts: list, K: int, D: int):
    """Host packing of a job list into head/tail windows + length arrays
    (numpy, no per-base python loops beyond the slice copies)."""
    B = len(qs)
    HP, HS = HEAD(K, D), TAIL(K, D)
    qh = np.full((B, HP), 4, np.int32)
    th = np.full((B, HP), 4, np.int32)
    qt = np.full((B, HS), 4, np.int32)
    tt = np.full((B, HS), 4, np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b, (qa, ta) in enumerate(zip(qs, ts)):
        nq, nt = len(qa), len(ta)
        qlen[b], tlen[b] = nq, nt
        qh[b, :min(nq, HP)] = qa[:HP]
        th[b, :min(nt, HP)] = ta[:HP]
        zq = min(nq, HS)
        qt[b, HS - zq:] = qa[nq - zq:]
        zt = min(nt, HS)
        tt[b, HS - zt:] = ta[nt - zt:]
    return qh, th, qt, tt, qlen, tlen


def blocks_from_one_gap_ops(ops_row: np.ndarray, jump: int):
    """Host assembly of ascending blocks from one problem's end-first op
    stream (mirror of align.affine's final block emission)."""
    neg = np.nonzero(ops_row < 0)[0]
    n = int(neg[0]) if len(neg) else len(ops_row)
    seq = ops_row[:n][::-1]
    blocks = []
    qPos = tPos = 0
    run = 0
    for op in seq.tolist():
        if op == DIAG:
            if run == 0:
                rq, rt = qPos, tPos
            run += 1
            qPos += 1
            tPos += 1
            continue
        if run:
            blocks.append((rq, rt, run))
            run = 0
        if op == LEFT:
            qPos += 1
        elif op == DOWN:
            tPos += 1
        elif op == GAPLEFT:
            qPos += jump
        elif op == GAPDOWN:
            tPos += jump
    if run:
        blocks.append((rq, rt, run))
    return blocks
