"""Vectorized host DP for tiny gap jobs (both sides <= SMALL_MAX bases).

A 5%-error ONT read produces thousands of 1-10bp inter-anchor gaps per
batch; shipping each to the device kernel pays per-job python (bucket
fill, packed download, per-job traceback) that dwarfs the DP itself.
This module solves ALL tiny jobs of a round at once with numpy:

* forward pass: classic global alignment H[i,j] (same linear-gap scoring
  as ops/affine_kernel.banded_global_kernel: match/mismatch/indel), rows
  vectorized across jobs; the in-row left-dependency is exact via the
  cummax identity  max_k<j (H[i,k] + ind*(j-k)) = (cummax of
  H[i,k] - ind*k) + ind*j  (indel penalty is linear).
* traceback: all jobs walk simultaneously (gather per step), emitting a
  move code per step; diagonal runs become blocks.

Semantics match the device kernel exactly (same scores, same
prefer-diagonal tie order), so routing by size is output-invariant.
"""

from __future__ import annotations

import numpy as np

# 16 is the measured sweet spot on a 1-core host: the DP is O(N*L^2)
# (19k jobs: 0.33s at L=16, 0.7-1.4s at L=32), while the device round it
# replaces costs ~0.2s for the 17-64 size classes — larger L loses more
# to host FLOPs than it saves in device round-trips
SMALL_MAX = 16


def solve_small_jobs(qs: list, ts: list, m: int, mm: int, ind: int,
                     kbands=None) -> list:
    """qs/ts: per-job code arrays, all lengths in [1, SMALL_MAX].
    kbands: optional per-job band halfwidth (cells |i-j| > kb are rails,
    the device kernel's in_band rule).  Returns [(q_off, t_off, len)]
    block lists per job."""
    N = len(qs)
    if N == 0:
        return []
    L = SMALL_MAX
    NEG = np.int32(-(10 ** 8))
    q = np.full((N, L), 4, np.int8)
    t = np.full((N, L), 4, np.int8)
    ql = np.empty(N, np.int32)
    tl = np.empty(N, np.int32)
    for k in range(N):
        a, b = qs[k], ts[k]
        ql[k] = len(a)
        tl[k] = len(b)
        q[k, :len(a)] = a
        t[k, :len(b)] = b
    kb = (np.full(N, 2 * L, np.int32) if kbands is None
          else np.asarray(kbands, np.int32))

    # H[n, i, j]: i rows over q (0..ql), j cols over t (0..tl)
    H = np.full((N, L + 1, L + 1), NEG, np.int32)
    cols = np.arange(L + 1, dtype=np.int32)
    H[:, 0, :] = np.where(
        (cols[None, :] <= tl[:, None]) & (cols[None, :] <= kb[:, None]),
        cols[None, :] * ind, NEG)
    for i in range(1, L + 1):
        sub = np.where(q[:, i - 1:i] == t, m, mm).astype(np.int32)
        diag = H[:, i - 1, :-1] + sub        # [N, L]
        up = H[:, i - 1, 1:] + ind
        best = np.maximum(diag, up)
        row = np.full((N, L + 1), NEG, np.int32)
        row[:, 0] = H[:, i - 1, 0] + ind
        row[:, 1:] = best
        # left moves: running cummax of (row - ind*j) + ind*j
        adj = np.maximum.accumulate(row - cols[None, :] * ind, axis=1)
        row = np.maximum(row, adj + cols[None, :] * ind)
        valid = ((cols[None, :] <= tl[:, None]) & (i <= ql)[:, None]
                 & (np.abs(i - cols)[None, :] <= kb[:, None]))
        H[:, i, :] = np.where(valid, row, NEG)

    # vectorized traceback from (ql, tl): move codes 0=diag,1=up,2=left
    ci = ql.copy()
    cj = tl.copy()
    n_idx = np.arange(N)
    moves = np.zeros((N, 2 * L), np.int8)
    mi = np.zeros((N, 2 * L), np.int32)
    mj = np.zeros((N, 2 * L), np.int32)
    count = np.zeros(N, np.int32)
    for s in range(2 * L):
        active = (ci > 0) | (cj > 0)
        if not active.any():
            break
        i0 = np.maximum(ci - 1, 0)
        j0 = np.maximum(cj - 1, 0)
        hup = np.where(ci > 0, H[n_idx, i0, cj], NEG)
        hleft = np.where(cj > 0, H[n_idx, ci, j0], NEG)
        cur = H[n_idx, ci, cj]
        # device-kernel tie order (affine_kernel.py:99-105, the
        # reference's): ins (consume q) > del (consume t) > diagonal
        is_up = (ci > 0) & (hup + ind == cur)
        is_left = ~is_up & (cj > 0) & (hleft + ind == cur)
        mv = np.where(is_up, 1, np.where(is_left, 2, 0)).astype(np.int8)
        mv = np.where(active, mv, 3)
        moves[:, s] = mv
        mi[:, s] = ci
        mj[:, s] = cj
        ci = np.where(active & (mv != 2), ci - 1, ci)
        cj = np.where(active & (mv != 1), cj - 1, cj)
        count = np.where(active, count + 1, count)

    # diagonal-run extraction, vectorized (moves are end-to-start, so a
    # run's first step s has its largest coords and its last step its
    # smallest; the diag at step s consumes q[mi-1]/t[mj-1])
    steps = np.arange(2 * L, dtype=np.int32)[None, :]
    dmask = (moves == 0) & (steps < count[:, None])
    prev = np.zeros_like(dmask)
    prev[:, 1:] = dmask[:, :-1]
    nxt = np.zeros_like(dmask)
    nxt[:, :-1] = dmask[:, 1:]
    ks_a, ss_a = np.nonzero(dmask & ~prev)   # run begins (larger coords)
    ks_b, ss_b = np.nonzero(dmask & ~nxt)    # run ends (smaller coords)
    run_len = ss_b - ss_a + 1
    bq = mi[ks_b, ss_b] - 1
    bt = mj[ks_b, ss_b] - 1
    out = [[] for _ in range(N)]
    # reversed global (k, s) order gives, per job, ascending coordinates
    for r in range(len(ks_b) - 1, -1, -1):
        out[ks_b[r]].append((int(bq[r]), int(bt[r]), int(run_len[r])))
    return out
