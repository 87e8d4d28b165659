"""Big inter-anchor gap closure: reseed + forward-only SDP (the 3rd SDP).

Port of the >=300bp-gap branch of ``RefinedAlignmentbtwnAnchors``
(reference: LocalRefineAlignment.h:236-390): reseed the gap box with
small non-canonical minimizers (k in {6,9,12} chosen by gap size with
accuracy-matched waiting times), linearly extend, chain with the
forward-only SDP (reference: SparseDP_Forward.h:312 — the same machinery
restricted to lane 1), remove paired indels, and return the chained
anchors; the remaining sub-gaps go to the banded aligner.

The reverse-strand re-seed ("inversion in a gap") check is also ported:
when forward seeding is too sparse and identity < 0.8, the reverse strand
is tried; if it wins, the caller receives inversion=True and splits the
segment (reference: LocalRefineAlignment.h:292-352).

TPU batching: the seeding/extension is host work, but the chaining runs
on device — ``prepare_big_gap`` builds one forward-lane ChainProblem per
gap during the assembly walk, ``resolve_big_gaps`` solves every gap of
the batch in a single bucketed device round (chain/driver.solve_problems)
and splices the chained mid-anchors + sub-gap jobs back into the
segments.  The reference runs its forward-only SDP per gap inside the
per-read walk; here the 3rd SDP is one more batched device stage.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..align.extend import linear_extend_cluster, trim_overlapped_anchors
from ..chain.cleaners import AnchorChain, remove_paired_indels
from ..chain.driver import ChainProblem, solve_problems
from ..cluster.types import Cluster
from ..ops.gapcost import GapParams
from ..options import Options, ReadType
from .refine import refine_space


def _seed_params(max_dist: int):
    """k/w and min seeding ratio by gap size
    (reference: LocalRefineAlignment.h:263-283)."""
    if max_dist < 100:
        return 6, 5, 0.5 / 29.5
    if max_dist < 500:
        return 9, 7, 0.5 / 69.1
    return 12, 7, 0.5 / 140.2


def _space_diag(opts: Options, read_dist: int, sv_diag: int) -> int:
    if opts.read_type in (ReadType.CONTIG, ReadType.CCS):
        d = min(int(max(80.0, 0.01 * read_dist)), 500)
    else:
        d = min(int(max(100.0, 0.15 * read_dist)), 2000)
    return max(2 * sv_diag, d)


@dataclass
class BigGapTask:
    """One prepared big-gap chaining problem plus the context needed to
    splice its solved mid-anchors back into the owning segment."""
    problem: ChainProblem
    q: np.ndarray            # sorted anchors incl. flanking pseudo-anchors
    t: np.ndarray
    ln: np.ndarray
    q0: int
    q1: int
    t0: int
    t1: int
    prev_len: int
    # splice context (set by the assembly walk)
    seg: object = None
    key3: tuple = None       # (si, gi, zi)
    prev_q_end: int = 0
    prev_t_end: int = 0
    next_q: int = 0
    next_t: int = 0
    read: np.ndarray = None
    chrom: np.ndarray = None


def prepare_big_gap(read_strand: np.ndarray, chrom: np.ndarray,
                    opts: Options, q0: int, q1: int, t0: int, t1: int,
                    prev_len: int, next_len: int,
                    rc_strand: np.ndarray | None = None):
    """Seed + extend the gap box (host) and build the forward-only
    chaining problem.  Returns (task | None, inversion_detected):
    inversion means the caller must break the segment; None with no
    inversion means the gap falls through to plain banded alignment."""
    read_dist = q1 - q0
    genome_dist = t1 - t0
    max_dist = max(read_dist, genome_dist)
    sv_diag = max_dist - min(read_dist, genome_dist)
    k, w, min_ratio = _seed_params(max_dist)
    band = _space_diag(opts, read_dist, sv_diag)

    qp, tp, identity = refine_space(k, w, band, None, chrom, read_strand,
                                    opts, q0, q1, t0, t1)
    min_dist = min(read_dist, genome_dist)
    if (len(qp) / max(1, min_dist)) < min_ratio and 0 <= identity < 0.8 \
            and rc_strand is not None:
        # try the reverse strand over the flipped read window
        L = len(read_strand)
        q0r, q1r = L - q1, L - q0
        qp2, tp2, _ = refine_space(k, w, band, None, chrom, rc_strand,
                                   opts, q0r, q1r, t0, t1)
        if len(qp2) > len(qp):
            return None, True   # caller handles segment split / typing
    if len(qp) == 0:
        return None, False

    # linear extension of the seeds (forward frame)
    c = Cluster(qp, tp, 0, k, 1.0, 0)
    q, t, ln, _ = linear_extend_cluster(c, read_strand, chrom, k)
    trim_overlapped_anchors(q, t, ln, 0)
    keep = (ln > 0) & (q >= q0) & (q + ln <= q1) & (t >= t0) & (t + ln <= t1)
    q, t, ln = q[keep], t[keep], ln[keep]
    if len(q) == 0:
        return None, False

    # add flanking pseudo-anchors so chaining is anchored at both ends
    # (reference: LocalRefineAlignment.h:364-377)
    q = np.concatenate([[q0 - prev_len], q, [q1]]).astype(np.int64)
    t = np.concatenate([[t0 - prev_len], t, [t1]]).astype(np.int64)
    ln = np.concatenate([[prev_len], ln, [next_len]]).astype(np.int64)
    order = np.argsort(q, kind="stable")
    q, t, ln = q[order], t[order], ln[order]

    n = len(q)
    tbase = int(t.min())
    p = ChainProblem(q, q + ln, t - tbase, t + ln - tbase,
                     (ln * 2.0).astype(np.float32),
                     np.ones(n, bool), np.zeros(n, bool),   # forward-only
                     np.arange(n, dtype=np.int64), tbase)
    return BigGapTask(p, q, t, ln, q0, q1, t0, t1, prev_len), False


def finish_big_gap(task: BigGapTask) -> list:
    """Traceback the solved problem, clean, drop the flanking
    pseudo-anchors; returns [(q, t, len)] ascending."""
    p = task.problem
    if p.V is None or len(p.V) == 0:
        return []
    i = int(np.argmax(p.V))
    if not np.isfinite(p.V[i]) or p.V[i] <= 0:
        return []
    rows = []
    while i >= 0:
        rows.append(i)
        i = int(p.bp[i])
    rows = sorted(rows)
    q, t, ln = task.q, task.t, task.ln
    ac = AnchorChain(q[rows][::-1].copy(), t[rows][::-1].copy(),
                     ln[rows][::-1].copy(),
                     np.zeros(len(rows), np.uint8),
                     np.zeros(len(rows), np.int64))
    remove_paired_indels(ac, refine_ends=False)
    out = []
    q0, q1, t0, t1, prev_len = task.q0, task.q1, task.t0, task.t1, \
        task.prev_len
    for i in range(len(ac) - 1, -1, -1):
        bq, bt, bl = int(ac.qpos[i]), int(ac.tpos[i]), int(ac.length[i])
        # drop the flanking pseudo-anchors
        if (bq == q0 - prev_len and bt == t0 - prev_len) or \
           (bq == q1 and bt == t1):
            continue
        out.append((bq, bt, bl))
    out.sort()
    return out


def resolve_big_gaps(tasks: list, gap_jobs: list, gp: GapParams,
                     use_device: bool = True, device="cuda") -> None:
    """One batched device round for every big gap of the batch (the 3rd
    SDP, reference: SparseDP_Forward.h:312), then splice the chained
    mid-anchors into the owning segments and queue the residual sub-gaps
    for the banded aligner."""
    from .gap_align import GapJob

    if not tasks:
        return
    solve_problems([t.problem for t in tasks], gp, use_device, device)
    for task in tasks:
        mids = finish_big_gap(task)
        pq, pt = task.prev_q_end, task.prev_t_end
        si, gi, zi = task.key3
        for (mq, mt, ml) in mids:
            if mq < pq or mt < pt:
                continue
            if pq < mq and pt < mt:
                gap_jobs.append(GapJob(task.read[pq:mq],
                                       task.chrom[pt:mt],
                                       (si, gi, zi, pq, pt)))
            task.seg.blocks.append((mq, mt, ml))
            pq, pt = mq + ml, mt + ml
        if task.next_q > pq and task.next_t > pt:
            gap_jobs.append(GapJob(task.read[pq:task.next_q],
                                   task.chrom[pt:task.next_t],
                                   (si, gi, zi, pq, pt)))
