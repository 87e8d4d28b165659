"""Banded one-gap aligner (host reference implementation).

Behavioral re-implementation of the reference's ``AffineOneGapAlign``
(reference: AffineOneGapAlign.h:157-652).  Despite the name, intra-band
gaps are *linear* (``indel`` per base); the "one gap" is a single
arbitrarily long free gap on the longer sequence's axis that joins a
prefix band matrix to a suffix band matrix (its cost is charged later by
the concave CIGAR scorer, Alignment.h:467-495).

Semantics preserved:
* ``diag = max(1, min(qLen, tLen))``; ``k = min(diag, k)``;
  if ``diag + 2k >= max(qLen, tLen)`` the band is doubled and a single
  banded global alignment is done (no long gap) —
  AffineOneGapAlign.h:194-201.
* prefix DP tracks per-row maxima ``lowerDiagonalMax[j]`` (over cells with
  i < qLen-k, >= update: latest i wins) and per-column maxima
  ``upperDiagonalMax[i]`` (over cells with j < tLen, i < diag+1, > update:
  earliest j wins) — AffineOneGapAlign.h:344-356.
* the long gap skips query bases when qLen >= tLen (``delClose``) and
  target bases when tLen > qLen (``insClose``), at zero immediate cost.
* tie-break order: ins(query-consuming) > del > match > gapLeft > gapDown.
* output: match blocks (qPos, tPos, len) and the final score.

This module is the exact oracle and host fallback; the batched device
kernel lives in ops/affine_kernel.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MISSING = -(1 << 60)

# arrows (reference: AffineOneGapAlign.h:163-170)
DONE, LEFT, DOWN, DIAG, BORDER, GAPLEFT, GAPDOWN = range(7)


@dataclass
class AlnResult:
    score: int
    # match blocks: (qPos, tPos, len), ascending
    blocks: list = field(default_factory=list)
    # raw op run-list [(op, len)] in alignment order (query-leading)
    ops: list = field(default_factory=list)


def fast_one_gap_align(q: np.ndarray, t: np.ndarray, m: int, mm: int,
                       indel: int, k: int) -> AlnResult:
    """Drop-in for affine_one_gap_align that takes the row-vectorized
    banded-global path when the band covers the drift (the common case;
    blocks identical — see tests/test_affine_kernel.py), falling back to
    the per-cell one-gap DP otherwise."""
    qLen, tLen = len(q), len(t)
    diag = max(1, min(qLen, tLen))
    kk = min(diag, k)
    if qLen and tLen and diag + 2 * kk >= max(qLen, tLen):
        K = 2 * kk
        from .. import native

        res = native.banded_align(q, t, K, K, m, mm, indel)
        if res is not None:
            blocks, score = res
            return AlnResult(score, blocks, [])
        from ..ops.affine_kernel import banded_global_np, traceback_banded

        score, arrows = banded_global_np(
            q.reshape(1, -1).astype(np.int8), t.reshape(1, -1).astype(np.int8),
            np.array([qLen], np.int32), np.array([tLen], np.int32),
            K, m, mm, indel, np.array([K], np.int32))
        blocks, ops = traceback_banded(arrows[0], qLen, tLen, K)
        return AlnResult(int(score[0]), blocks, ops)
    return affine_one_gap_align(q, t, m, mm, indel, k)


def affine_one_gap_align(q: np.ndarray, t: np.ndarray, m: int, mm: int,
                         indel: int, k: int) -> AlnResult:
    """q, t: uint8 code arrays (0..3, 4=N). Returns blocks + score."""
    qLen, tLen = len(q), len(t)
    diag = max(1, min(qLen, tLen))
    k = min(diag, k)
    align_top = True
    if diag + 2 * k >= max(qLen, tLen):
        k = 2 * k
        align_top = False

    # dense matrices (host oracle favors clarity; band limits enforced by
    # masks identical to the reference's rails)
    P = np.full((qLen + 1, tLen + 1), MISSING, dtype=np.int64)
    Pp = np.full((qLen + 1, tLen + 1), -1, dtype=np.int8)

    lowerMax = np.full(diag + 1, MISSING, dtype=np.int64)
    lowerIdx = np.zeros(diag + 1, dtype=np.int64)
    upperMax = np.full(diag + 1, MISSING, dtype=np.int64)
    upperIdx = np.zeros(diag + 1, dtype=np.int64)
    if qLen >= tLen:
        lowerMax[0] = 0
        lowerIdx[0] = 0
    if qLen <= tLen:
        upperMax[0] = 0
        upperIdx[0] = 0

    P[0, 0] = 0
    Pp[0, 0] = DONE
    for i in range(1, k + 1):
        if i <= qLen:
            P[i, 0] = indel * i
            Pp[i, 0] = LEFT
    for j in range(1, min(k + 2, tLen + 1)):
        P[0, j] = indel * j
        Pp[0, j] = DOWN

    qBoundary = min(diag + k, qLen + 1)
    tBoundary = min(diag + k, tLen + 1)

    for j in range(1, tBoundary):
        for i in range(max(1, j - k), min(qBoundary, j + k + 1)):
            sIns = P[i - 1, j] + indel
            sDel = P[i, j - 1] + indel
            sMat = P[i - 1, j - 1] + (m if q[i - 1] == t[j - 1] else mm)
            best = max(sIns, sDel, sMat)
            P[i, j] = best
            if best == sIns:
                Pp[i, j] = LEFT
            elif best == sDel:
                Pp[i, j] = DOWN
            else:
                Pp[i, j] = DIAG
            if i < qLen - k and j <= diag:
                if P[i, j] >= lowerMax[j]:
                    lowerMax[j] = P[i, j]
                    lowerIdx[j] = i
            if j < tLen and i < diag + 1:
                if P[i, j] > upperMax[i]:
                    upperMax[i] = P[i, j]
                    upperIdx[i] = j

    ops: list = []
    lengths: list = []

    def push(op, ln=1):
        if not ops or ops[-1] != op:
            ops.append(op)
            lengths.append(ln)
        else:
            lengths[-1] += ln

    if align_top:
        S = np.full((qLen + 1, tLen + 1), MISSING, dtype=np.int64)
        Sp = np.full((qLen + 1, tLen + 1), -1, dtype=np.int8)
        qStart = max(0, qLen - diag)
        tStart = max(0, tLen - diag)
        tLow = max(0, tLen - diag - k - 2)
        qLow = max(0, qLen - diag - k - 1)
        tEnd = tLen + 1
        qEnd = qLen + 1

        if qLen >= tLen:
            # boundary: query-gap close along the left edge of the suffix band
            j = 0
            for i in range(qLow, qStart + k + 1):
                S[i, j] = lowerMax[j]
                Sp[i, j] = GAPLEFT
            i, j = qLow, 1
            for step in range(diag):
                if i < qLen + 1 and j < tLen + 1 and j <= diag:
                    S[i, j] = lowerMax[j]
                    Sp[i, j] = GAPLEFT
                i += 1
                j += 1
        if qLen <= tLen:
            i = qStart
            for j in range(tLow, min(tStart + k + 2, tLen + 1)):
                S[i, j] = upperMax[0]
                Sp[i, j] = GAPDOWN
            i, j = qStart + 1, tStart + 1
            while j < tEnd:
                if 0 <= j - k - 1 and i <= diag:
                    S[i, j - k - 1] = upperMax[i]
                    Sp[i, j - k - 1] = GAPDOWN
                i += 1
                j += 1

        for j in range(tLow + 1, tEnd):
            doff = diag + 1 - (tEnd - j)
            for i in range(max(qLow + 1, qStart + doff - k),
                           min(qEnd, qStart + doff + k + 1)):
                delClose = lowerMax[j] if (qLen >= tLen and j <= diag) else MISSING
                insClose = upperMax[i] if (tLen > qLen and i <= diag) else MISSING
                sIns = S[i - 1, j] + indel
                sDel = S[i, j - 1] + indel
                sMat = S[i - 1, j - 1] + (m if q[i - 1] == t[j - 1] else mm)
                best = max(delClose, insClose, sIns, sDel, sMat)
                S[i, j] = best
                if best == sIns:
                    Sp[i, j] = LEFT
                elif best == sDel:
                    Sp[i, j] = DOWN
                elif best == sMat:
                    Sp[i, j] = DIAG
                elif best == delClose:
                    Sp[i, j] = GAPLEFT
                else:
                    Sp[i, j] = GAPDOWN

        i, j = qLen, tLen
        score = int(S[i, j])
        arrow = Sp[i, j]
        while arrow not in (DONE, GAPDOWN, GAPLEFT) and i >= 0 and j >= 0:
            push(arrow)
            if arrow == DIAG:
                i -= 1
                j -= 1
            elif arrow == LEFT:
                i -= 1
            elif arrow == DOWN:
                j -= 1
            if i >= 0 and j >= 0:
                arrow = Sp[i, j]
        if arrow == GAPDOWN:
            push(GAPDOWN, int(j - upperIdx[i]))
            j = int(upperIdx[i])
        elif arrow == GAPLEFT:
            push(GAPLEFT, int(i - lowerIdx[j]))
            i = int(lowerIdx[j])
    else:
        i, j = qBoundary - 1, tBoundary - 1
        score = int(P[i, j])

    arrow = Pp[i, j]
    while arrow not in (BORDER, DONE, -1) and i >= 0 and j >= 0:
        push(arrow)
        if arrow == DIAG:
            i -= 1
            j -= 1
        elif arrow == LEFT:
            i -= 1
        elif arrow == DOWN:
            j -= 1
        arrow = Pp[i, j]

    # ops collected end->start; emit blocks start->end
    res = AlnResult(score)
    qPos = tPos = 0
    for op, ln in zip(ops[::-1], lengths[::-1]):
        if op in (LEFT, GAPLEFT):
            qPos += ln
        elif op in (DOWN, GAPDOWN):
            tPos += ln
        elif op == DIAG:
            res.blocks.append((qPos, tPos, ln))
            qPos += ln
            tPos += ln
        res.ops.append((op, ln))
    return res
