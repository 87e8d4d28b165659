"""Plain reference of the whole chaining SDP of one problem, in torch
float32, on the CPU or the card.

Written from lra's chaining recurrence (SparseDP.h), the same one
reference/sdp.py states; no code of the program is called.  Fragments
i = 0..N-1 are sorted by qS.  Fragment j precedes i on lane 1 (forward
diagonal) when both are lane-1 fragments, qE[j] <= qS[i] and
tE[j] <= tS[i]; on lane 2 (back diagonal) when both are lane-2
fragments, qE[j] <= qS[i] and tS[j] >= tE[i]; only j < i counts.  The
pair's weight is -PWL(|d_i - d_j| + 1) on the diagonals d1 = t - q
(lane 1: tS - qS of i, tE - qE of j) and d2 = t + q (lane 2: tE + qS of
i, tS + qE of j), and

    V[i] = score[i] + max(0, max over predecessors j of (V[j] + w))

with every sum rounded to float32.  Every predecessor counts: there is
no near window, no far term, no schedule and no q-range shard, which is
what the program's windowed kernel (for problems past 8192 fragments)
and its shards stand in for.  One row at a time, its predecessors as
one vector operation, so a problem of tens of thousands of fragments
fits on the card; ``solve_many`` takes the same row of several problems
at once.

Departures from lra's description:

* lra finds each row's best predecessor by a sparse sweep over the
  plane (row and column orders, a max-structure per diagonal); this
  enumerates every earlier fragment.  The maxima are the same; a row
  with tied best predecessors may name another of them, so a back
  pointer is judged by whether it attains V, not by which one it is.
* lra keeps its gap cost in float and its sums in float32; the PWL is
  reference/sdp.py's (lra's 25 breakpoints, floored, two ceilings).
* The best chain is traced from the row of the largest V (the first
  such row), through a best predecessor of each row, lane 1's where the
  lanes tie; lra's multi-chain selection is not part of this.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference.sdp import STOPS


def _pwl(x, slope, inter, stops, c1, c2):
    """reference/sdp.py's pwl on int64 tensors: the piece's slope * x +
    intercept (two float32 roundings), floored, the plateau between the
    ceilings c1 and c2 (float32 scalar tensors) set to c1, capped at c2,
    0 for x <= 2."""
    piece = (torch.searchsorted(stops, x, right=True) - 1).clamp(
        0, len(stops) - 2)
    s = slope[piece]
    pen = x.to(torch.float32) * s
    pen = pen + inter[piece]
    pen = torch.where(s == 0, torch.zeros_like(pen), pen).floor()
    pen = torch.where((pen >= c1) & (pen < c2), c1, pen)
    pen = torch.where(pen > c2, c2, pen)
    return torch.where(x <= 2, torch.zeros_like(pen), pen)


def solve(qS, qE, tS, tE, score, lane1, lane2, gaps, device="cpu",
          port=None) -> dict:
    """The problem's V (numpy float32), each row's best predecessor
    (``pred``, -1 where it took none), its best chain (``chain``: rows,
    the chain's end first) and that chain's score (``best``: the largest
    V, or 0 for an empty problem); with ``port`` = the program's (V, bp,
    lane), also ``bad_rows``: the rows whose V is not this V exactly, or
    whose back pointer and lane do not attain it (a row that took a
    predecessor must name one that attains its V on that lane, any of
    several tied ones; a row that took none has bp -1 and lane 0), the
    criterion of reference/sdp.py's ``Chain.bad_rows``.  ``gaps`` is
    (slope f32[24], inter f32[24], ceiling1, ceiling2)
    (reference/sdp.py's ``pwl_params`` and the preset's ceilings)."""
    return solve_many([(qS, qE, tS, tE, score, lane1, lane2)], gaps, device,
                      None if port is None else [port])[0]


def solve_many(problems: list, gaps, device="cpu", ports=None) -> list:
    """``solve`` of each problem (qS, qE, tS, tE, score, lane1, lane2),
    with ``ports`` its program's (V, bp, lane) if given: one row index of
    every problem at a time, the problems padded to the longest with rows
    that are never a predecessor."""
    dev = torch.device(device)
    i64, f32 = torch.int64, torch.float32
    P = len(problems)
    sizes = [len(np.asarray(pr[0])) for pr in problems]
    N = max(sizes, default=0)

    def pad(k, dtype, src=None):
        out = np.zeros((P, max(N, 1)), dtype)
        for b, pr in enumerate(src if src is not None else problems):
            a = np.asarray(pr[k])
            out[b, :len(a)] = a
        return torch.as_tensor(out, device=dev)

    qS, qE, tS, tE = (pad(k, np.int64) for k in range(4))
    score = pad(4, np.float32)
    l1, l2 = pad(5, bool), pad(6, bool)
    valid = torch.as_tensor(np.arange(max(N, 1))[None, :]
                            < np.array(sizes)[:, None], device=dev)
    lanes = [bool(np.any([np.any(pr[5]) for pr in problems])),
             bool(np.any([np.any(pr[6]) for pr in problems]))]
    slope = torch.as_tensor(np.asarray(gaps[0], np.float32), device=dev)
    inter = torch.as_tensor(np.asarray(gaps[1], np.float32), device=dev)
    stops = torch.as_tensor(STOPS, device=dev)
    c1 = torch.tensor(float(gaps[2]), dtype=f32, device=dev)
    c2 = torch.tensor(float(gaps[3]), dtype=f32, device=dev)
    d1s, d1e = tS - qS, tE - qE
    d2s, d2e = tE + qS, tS + qE
    V = torch.zeros((P, max(N, 1)), dtype=f32, device=dev)
    pred = torch.full((P, max(N, 1)), -1, dtype=i64, device=dev)
    if ports is not None:
        pV = pad(0, np.float32, ports)
        pbp, plane = pad(1, np.int64, ports), pad(2, np.int64, ports)
        bad = torch.zeros((P, max(N, 1)), dtype=torch.bool, device=dev)
    ninf = torch.tensor(float("-inf"), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    rows = torch.arange(P, device=dev)
    if N:
        V[:, 0] = score[:, 0]
        if ports is not None:
            bad[:, 0] = (pV[:, 0] != V[:, 0]) | (pbp[:, 0] != -1) | \
                (plane[:, 0] != 0)
    for i in range(1, N):
        j = slice(0, i)
        vis = valid[:, j] & (qE[:, j] <= qS[:, i:i + 1])
        arms = []
        for on, lane, ok, ds, de in (
                (lanes[0], l1, lambda: tE[:, j] <= tS[:, i:i + 1], d1s, d1e),
                (lanes[1], l2, lambda: tS[:, j] >= tE[:, i:i + 1], d2s, d2e)):
            if not on:           # no problem has a fragment on this lane
                arms.append(torch.full((P, i), float("-inf"), dtype=f32,
                                       device=dev))
                continue
            m = vis & ok() & lane[:, j] & lane[:, i:i + 1]
            w = _pwl((ds[:, i:i + 1] - de[:, j]).abs() + 1, slope, inter,
                     stops, c1, c2)
            arms.append(torch.where(m, V[:, j] - w, ninf))
        a1, a2 = arms
        b1, k1 = a1.max(1)
        b2, k2 = a2.max(1)
        best = torch.maximum(b1, b2)
        take = best > 0
        V[:, i] = score[:, i] + torch.where(take, best, zero)
        pred[:, i] = torch.where(take, torch.where(b1 >= b2, k1, k2),
                                 torch.full_like(k1, -1))
        if ports is not None:
            jp, ln = pbp[:, i], plane[:, i]
            jc = jp.clamp(0, i - 1)
            got = torch.where(ln == 1, a1[rows, jc], a2[rows, jc])
            ok_take = (jp >= 0) & (jp < i) & ((ln == 1) | (ln == 2)) & \
                (got == best)
            ok_none = (jp == -1) & (ln == 0)
            bad[:, i] = (pV[:, i] != V[:, i]) | \
                ~torch.where(take, ok_take, ok_none)
    Vh, ph = V.cpu().numpy(), pred.cpu().numpy()
    badh = bad.cpu().numpy() if ports is not None else None
    out = []
    for b, n in enumerate(sizes):
        v = Vh[b, :n]
        chain = []
        k = int(np.argmax(v)) if n else -1
        if k >= 0 and v[k] > 0:
            while k >= 0:
                chain.append(k)
                k = int(ph[b, k])
        r = {"V": v.copy(), "pred": ph[b, :n].copy(), "chain": chain,
             "best": float(v.max()) if n else 0.0}
        if badh is not None:
            r["bad_rows"] = np.flatnonzero(badh[b, :n])
        out.append(r)
    return out
