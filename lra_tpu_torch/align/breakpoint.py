"""Breakpoint refinement between adjacent split segments.

Port of the reference's ``RefineBreakpoint`` (reference:
RefineBreakpoint.h:210-460): when two adjacent segments leave an
unaligned read span < 500bp between them, run a free-end local DP
forward from the left segment's end and backward from the right
segment's start (scores +2/-2/-4, RefineBreakpoint.h:300-302), pick the
query split maximizing the summed scores, and extend both segments'
block lists.  Reverse-strand segments extend in their RC frame
(prefix extension).

Our split search considers max-over-target scores at every query column
(a superset of the reference's walk along the single best path) — same
or better split, same scoring.

Flag quirk preserved by the callers: the high-accuracy path runs this
when --refineBreakpoints is NOT set, the low-accuracy path when it IS
(reference: Map_highacc.h:723 vs Map_lowacc.h:585).
"""

from __future__ import annotations

import numpy as np

MAX_GAP = 500
MAT, MIS, GAP = 2, -2, -4


def _free_end_dp(q: np.ndarray, t: np.ndarray):
    """Local-prefix DP: score[i,j] of aligning q[:j] vs t[:i] ending
    anywhere, with free start at (0,0) only (global prefix).  Returns
    (score, path) int matrices [len(t)+1, len(q)+1]."""
    qs, ts = len(q), len(t)
    score = np.zeros((ts + 1, qs + 1), dtype=np.int32)
    path = np.full((ts + 1, qs + 1), -1, dtype=np.int8)
    LEFT, DOWN, DIAG = 1, 2, 3
    score[0, 1:] = np.arange(1, qs + 1) * GAP
    path[0, 1:] = LEFT
    score[1:, 0] = np.arange(1, ts + 1) * GAP
    path[1:, 0] = DOWN
    for i in range(1, ts + 1):
        sub = np.where(q == t[i - 1], MAT, MIS).astype(np.int32)
        diag = score[i - 1, :-1] + sub
        down = score[i - 1, 1:] + GAP
        row = np.maximum(diag, down)
        p = np.where(row == diag, DIAG, DOWN).astype(np.int8)
        # LEFT closure within the row (linear gaps): running max
        prev = score[i, 0]
        for j in range(1, qs + 1):
            left = prev + GAP
            if left > row[j - 1]:
                row[j - 1] = left
                p[j - 1] = LEFT
            prev = row[j - 1]
        score[i, 1:] = row
        path[i, 1:] = p
    return score, path


def _traceback(path, i, j):
    """Blocks [(q, t, len)] from (0,0) to (j, i) exclusive."""
    LEFT, DOWN, DIAG = 1, 2, 3
    ops = []
    while i > 0 or j > 0:
        a = path[i, j]
        if a == DIAG:
            ops.append("M")
            i -= 1
            j -= 1
        elif a == LEFT:
            ops.append("I")
            j -= 1
        elif a == DOWN:
            ops.append("D")
            i -= 1
        else:
            break
    ops.reverse()
    blocks = []
    q = t = 0
    for op in ops:
        if op == "M":
            if blocks and blocks[-1][0] + blocks[-1][2] == q and \
               blocks[-1][1] + blocks[-1][2] == t:
                blocks[-1] = (blocks[-1][0], blocks[-1][1],
                              blocks[-1][2] + 1)
            else:
                blocks.append((q, t, 1))
            q += 1
            t += 1
        elif op == "I":
            q += 1
        else:
            t += 1
    return blocks


def refine_breakpoint(left, right, read_len: int,
                      left_read: np.ndarray, right_read: np.ndarray,
                      left_chrom: np.ndarray, right_chrom: np.ndarray
                      ) -> None:
    """left/right: Segment objects; left is leftward on the read.
    left_read/right_read: code arrays in each segment's strand frame."""
    if not left.blocks or not right.blocks:
        return
    # forward-read coordinates of the segment ends
    if left.strand == 0:
        flqe = left.qEnd
    else:
        flqe = read_len - left.qStart
    if right.strand == 0:
        frqs = right.qStart
    else:
        frqs = read_len - right.qEnd
    if not (frqs > flqe and frqs - flqe < MAX_GAP):
        return
    span = frqs - flqe

    # left extension strings
    if left.strand == 0:
        lq = left_read[left.qEnd:left.qEnd + span]
        t0 = left.tEnd
        tspan = min(len(left_chrom) - t0, span)
        lt = left_chrom[t0:t0 + tspan]
        l_prefix = False
    else:
        if left.qStart - span < 0:
            return
        lq = left_read[left.qStart - span:left.qStart][::-1]
        te = left.tStart
        t0 = max(0, te - span)
        lt = left_chrom[t0:te][::-1]
        l_prefix = True
    # right extension strings
    if right.strand == 0:
        if right.qStart - span < 0:
            return
        rq = right_read[right.qStart - span:right.qStart][::-1]
        te = right.tStart
        t0 = max(0, te - span)
        rt = right_chrom[t0:te][::-1]
        r_prefix = True
    else:
        rq = right_read[right.qEnd:right.qEnd + span]
        t0 = right.tEnd
        tspan = min(len(right_chrom) - t0, span)
        rt = right_chrom[t0:t0 + tspan]
        r_prefix = False

    ls, lp = _free_end_dp(lq, lt)
    rs, rp = _free_end_dp(rq, rt)

    # best split: left consumes s query bases, right consumes <= span - s
    lbest_t = ls.max(axis=0)          # [span+1] best score per q columns
    largmax_t = ls.argmax(axis=0)
    rbest_t = rs.max(axis=0)
    rargmax_t = rs.argmax(axis=0)
    s_scores = np.array([lbest_t[s] + rbest_t[span - s]
                         for s in range(span + 1)])
    s = int(np.argmax(s_scores))
    if s_scores[s] <= 0:
        return
    mlq, mlt = s, int(largmax_t[s])
    mrq, mrt = span - s, int(rargmax_t[span - s])

    lblocks = _traceback(lp, mlt, mlq)
    rblocks = _traceback(rp, mrt, mrq)

    def attach(seg, blocks, prefix, q_hi, t_hi, q_lo, t_lo):
        if not blocks:
            return
        if prefix:
            # blocks are in reversed strings: map back
            mapped = [(q_hi - (bq + bl), t_hi - (bt + bl), bl)
                      for (bq, bt, bl) in blocks]
            mapped.sort()
            seg.blocks[:0] = mapped
        else:
            mapped = [(q_lo + bq, t_lo + bt, bl) for (bq, bt, bl) in blocks]
            seg.blocks.extend(mapped)
        # merge adjacency + enforce monotonicity; zero-length op-order
        # markers (see splice_refined_blocks) pass through in-order
        out = []
        pq = pt = -1
        for (bq, bt, bl) in seg.blocks:
            if bq >= pq and bt >= pt and bl >= 0:
                if out and out[-1][0] + out[-1][2] == bq and \
                   out[-1][1] + out[-1][2] == bt:
                    if bl > 0:
                        out[-1] = (out[-1][0], out[-1][1],
                                   out[-1][2] + bl)
                elif bl > 0 or out:
                    out.append((bq, bt, bl))
                pq, pt = bq + bl, bt + bl
        while out and out[-1][2] == 0:
            out.pop()
        seg.blocks = out

    if l_prefix:
        attach(left, lblocks, True, left.qStart, left.tStart, 0, 0)
    else:
        attach(left, lblocks, False, 0, 0, left.qEnd, left.tEnd)
    if r_prefix:
        attach(right, rblocks, True, right.qStart, right.tStart, 0, 0)
    else:
        attach(right, rblocks, False, 0, 0, right.qEnd, right.tEnd)
