"""Device one-long-gap banded aligner (K6; plain torch in this port).

Batched DP for the separated prefix/suffix band regime of the
reference's ``AffineOneGapAlign`` (reference: AffineOneGapAlign.h:157,
194-201): when |qLen - tLen| > 2k the alignment is a k-banded prefix
matrix from (0,0), a k-banded suffix matrix anchored at (qLen,tLen), and
ONE free arbitrarily-long gap joining them (a column-max closure when
the query is longer, a row-max closure when the target is longer).

Bit-identical to lra_tpu's jitted one_gap_traced and through it to the
host oracle ``align.affine.affine_one_gap_align``
(same integer scores, same tie order LEFT > DOWN > DIAG > GAPLEFT >
GAPDOWN, same >=-latest / >-earliest closure argmax conventions, same
border seeding) — enforced by tests/test_one_gap.py fuzzing.

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

import numpy as np
import torch

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
    """Batched one-long-gap alignment with traceback (plain torch, run
    on the tensors' device).

    q_head/t_head: int32[B, D+K] (codes from position 0), q_tail/t_tail:
    int32[B, D+K+4] (tail[z] = seq[len - (D+K+4) + z]), qlen/tlen/kband:
    int32[B] with kband <= K, min(qlen,tlen) <= D, and the one-gap
    regime min + 2*kband < max for every problem.

    Returns (ops int8[B, L] end-first with codes LEFT/DOWN/DIAG/
    GAPLEFT/GAPDOWN and -1 padding, jump_len int32[B], score f32[B])."""
    parr, lmax, lidx, up, upi = _prefix_pass(
        q_head, qlen, tlen, kband, K, D, m, mm, indel, t_head)
    sarr, score = _suffix_pass(q_tail, t_tail, qlen, tlen, kband, K, D, m,
                               mm, indel, lmax, up)
    ops, jump = _traceback(parr, sarr, qlen, tlen, kband, K, lidx, upi, L)
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
