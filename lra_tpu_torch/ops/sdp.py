"""Concave-gap chaining DP (the SDP core): the numpy oracles.

The device kernel is ops/sdp_blocked.py; this module keeps lra_tpu's
single-problem oracle (the host path's chaining, use_device=False) and
the host traceback.  They replace the reference's event-sweep SDP
(reference: SparseDP.h:1766-2440) with the same optimum.

Recurrence (derived from ProcessPoint, SparseDP.h:313-662):

    V[i] = score[i] + max(0, max_j  V[j] + w(lane))

with predecessor j valid through
  lane 1 (forward diagonal, subproblems R1/C1):
      qE[j] <= qS[i]  and  tE[j] <= tS[i],
      w = -PWL(|(tS[i]-qS[i]) - (tE[j]-qE[j])| + 1)
  lane 2 (back diagonal, subproblems R2/C2):
      qE[j] <= qS[i]  and  tS[j] >= tE[i],
      w = -PWL(|(tE[i]+qS[i]) - (tS[j]+qE[j])| + 1)

Lane membership encodes the reference's two insertion rules: SDP-1 inserts
all four points per fragment (both lanes; inversion-aware chaining,
SparseDP.h:1957-2040), SDP-2 inserts one lane per strand
(SparseDP.h:1797-1807).  A strand flip along the traceback is a `link`
(inversion edge, SparseDP.h:1537-1565).
"""

from __future__ import annotations

import numpy as np

from .gapcost import GapParams


# ------------------------------------------------------------------ host ---

def chain_scores_np(qS, qE, tS, tE, score, lane1, lane2, valid, gp: GapParams):
    """Single-problem numpy oracle with identical semantics (for tests and
    small host-side fallbacks)."""
    from .gapcost import gap_cost_np

    n = len(qS)
    V = np.full(n, -3.0e38, dtype=np.float64)
    bp = np.full(n, -1, dtype=np.int64)
    lane = np.zeros(n, dtype=np.int64)
    d1s, d1e = tS - qS, tE - qE
    d2s, d2e = tE + qS, tS + qE
    for i in range(n):
        if not valid[i]:
            continue
        best, bj, bl = 0.0, -1, 0
        for j in range(n):
            if not valid[j] or qE[j] > qS[i]:
                continue
            if lane1[i] and lane1[j] and tE[j] <= tS[i]:
                c = V[j] + gap_cost_np(d1s[i], d1e[j], gp)
                if c > best:
                    best, bj, bl = c, j, 1
            if lane2[i] and lane2[j] and tS[j] >= tE[i]:
                c = V[j] + gap_cost_np(d2s[i], d2e[j], gp)
                if c > best:
                    best, bj, bl = c, j, 2
        V[i] = score[i] + best
        bp[i], lane[i] = bj, bl
    return V, bp, lane


def traceback(V, bp, lane, valid, used=None):
    """Extract the best chain (host).  Returns (indices ascending by qS,
    links) where links[k]=True marks a lane flip between step k and k+1 —
    the reference's inversion edge (SparseDP.h:1537-1565)."""
    V = np.where(valid, V, -np.inf)
    if used is not None:
        V = np.where(used, -np.inf, V)
    i = int(np.argmax(V))
    if not np.isfinite(V[i]):
        return np.zeros(0, np.int64), np.zeros(0, bool)
    chain = []
    lanes = []
    while i >= 0:
        chain.append(i)
        lanes.append(lane[i])
        i = int(bp[i])
    chain = np.array(chain[::-1], dtype=np.int64)
    lanes = np.array(lanes[::-1], dtype=np.int64)
    links = np.zeros(len(chain), dtype=bool)
    if len(chain) > 1:
        links[1:] = lanes[1:] == 2
    return chain, links
