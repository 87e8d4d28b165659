"""Indel consolidation + end extension over assembled block lists.

Behavioral port of the reference's ``IndelRefineAlignment``
(reference: IndelRefine.h:53-787): runs of blocks separated by
< refine_band-1 gaps (interior blocks < 100bp) are re-aligned with a
banded DP so nearby small indels consolidate; with ``end_align`` the
alignment is first extended by up to 40bp of assumed match at each read
end (IndelRefine.h:89-127).

Mechanism difference (documented): the reference carves a shaped band
that follows the existing path through the region; we re-align the whole
region with the banded-global kernel (band = refine_band + drift), which
explores a superset of that band — same or better optimum, same scoring.
Regions are solved as batched device jobs alongside the gap-closing ones.
"""

from __future__ import annotations

import numpy as np

from ..options import Options
from ..pipeline.gap_align import GapJob, diag_gap_guard, job_block_list


def plan_end_extension(seg, read_len: int, chrom_len: int) -> None:
    """end_align: prepend/append <=40bp assumed-match blocks
    (reference: IndelRefine.h:89-127)."""
    if not seg.blocks:
        return
    q0, t0, _ = seg.blocks[0]
    m = min(q0, t0)
    if 0 < m < 40:
        seg.blocks.insert(0, (q0 - m, t0 - m, m))
    qe = seg.qEnd
    te = seg.tEnd
    m = min(read_len - qe, chrom_len - te)
    if 0 < m < 40:
        seg.blocks.append((qe, te, m))


def plan_refine_regions(seg, opts: Options):
    """Group block runs to re-align (reference: IndelRefine.h:133-230).

    Regions TILE the block list the way the reference's walk does:
    consecutive regions share a boundary block whose bases are
    progressively consumed — a region takes the first max_gap bases of a
    long end block and the remainder becomes the next region's start
    flank (IndelRefine.h:197-211, 765-771); a short end block is
    consumed whole and the next region starts after it.

    Returns list of (lo, hi_inclusive, trim0, keep1): the region's
    window is blocks[lo] offset by trim0 .. blocks[hi] + keep1."""
    blocks = seg.blocks
    max_gap = opts.refine_band - 1
    regions = []
    i = 0
    consumed = 0    # bases of blocks[i] consumed by the previous region
    n = len(blocks)
    while i < n:
        j = i
        # the region's window starts at the last max_gap unconsumed bases
        # of blocks[i] (the trim0 logic below); the span cap must measure
        # from THERE, not blocks[i][0] — measuring from the block start
        # made any region following a long flank block blow the cap
        # immediately and get planned without its left flank, putting
        # consolidations that move the flank boundary out of DP reach
        while j < n - 1:
            q, t, ln = blocks[j]
            qn, tn, ln_n = blocks[j + 1]
            qgap = qn - (q + ln)
            tgap = tn - (t + ln)
            # NO span cap: the reference groups until a >=100bp block or
            # a >=maxGap junction, with no length limit
            # (IndelRefine.h:147-165).  An artificial cap splits regions
            # mid-run and loses consolidations that cross the seam (two
            # 1D merging into one 2D across the cut was a measured
            # bit-identity residual).  Rare regions longer than the
            # S=2048 device bucket are solved on the host refine DP
            # instead (solve_gap_jobs long-refine routing).
            if qgap < max_gap and tgap < max_gap and \
               (j == i or blocks[j][2] < 100):
                j += 1
            else:
                break
        if j > i:
            eff_len = blocks[i][2] - consumed
            trim0 = consumed + max(0, eff_len - max_gap)
            keep1 = min(blocks[j][2], max_gap)
            regions.append((i, j, trim0, keep1))
            if blocks[j][2] > max_gap:
                i = j
                consumed = max_gap
            else:
                i = j + 1
                consumed = 0
        else:
            i += 1
            consumed = 0
    return regions


def queue_indel_refine_jobs(seg, read: np.ndarray, chrom: np.ndarray,
                            opts: Options, key_prefix: tuple) -> list:
    """Create banded re-alignment jobs for each fragmented region.
    Returns jobs whose key carries (block_lo, block_hi) for splicing."""
    jobs = []
    max_gap = opts.refine_band - 1
    # single-mismatch fast path: a region whose junctions are all
    # diagonal-preserving (qgap == tgap) AND whose WINDOW contains at
    # most ONE mismatched base total cannot be improved by the banded
    # re-DP — converting X mismatches to matches gains X*(m-mm) but
    # costs at least an ins+del pair 2|ind| plus one unalignable base m,
    # so with |mm| < 2|ind| the diagonal is strictly optimal only for
    # X <= 1 (X >= 2 CAN be beaten when a shift-periodic block separates
    # the SNPs, so those regions are re-DP'd like the reference does).
    # The count must cover every window base — block interiors included,
    # not just junction gaps: colinear blocks can carry mismatch runs
    # (e.g. a 3X from linear extension) that the DP can beat the same
    # way it beats junction ones.
    diag_ok = diag_gap_guard(opts)
    # native fast path: plan + trivial-region classification in one C
    # pass (the python while-loops below were ~0.15s/ONT batch)
    from .. import native

    nb = len(seg.blocks)
    if nb == 0:
        seg.refine_plan = []
        return jobs
    bl = np.asarray(seg.blocks, np.int64).reshape(nb, 3)
    res = native.plan_indel_regions(bl, read, chrom,
                                    max_gap, 1 << 30, diag_ok,
                                    opts.refine_band)
    if res is not None:
        seg.refine_plan = [tuple(r) for r in res[:, :4].tolist()]
        for lo, hi, trim0, keep1, q0, t0, q1, t1, band, kind in \
                res.tolist():
            if kind == 0:
                continue
            key = key_prefix + (lo, hi, q0, t0, trim0, keep1)
            if kind == 2:
                job = GapJob(read[q0:q1], chrom[t0:t1], key)
            else:
                job = GapJob(read[q0 + 1:q1], chrom[t0 + 1:t1], key)
                job.refine = True
                job.path = _job_path(bl, lo, hi, trim0, keep1, q0, t0)
            job.band = band
            jobs.append(job)
        return jobs
    plan = plan_refine_regions(seg, opts)
    seg.refine_plan = plan
    for (lo, hi, trim0, keep1) in plan:
        if diag_ok:
            diagonal = True
            for j in range(lo, hi):
                q0, t0, l0 = seg.blocks[j]
                q1, t1, _ = seg.blocks[j + 1]
                if q1 - (q0 + l0) != t1 - (t0 + l0):
                    diagonal = False
                    break
            if diagonal:
                wq0 = seg.blocks[lo][0] + trim0
                wt0 = seg.blocks[lo][1] + trim0
                wq1 = seg.blocks[hi][0] + keep1
                wt1 = seg.blocks[hi][1] + keep1
                mm_total = int(np.count_nonzero(
                    read[wq0:wq1] != chrom[wt0:wt1]))
                if mm_total <= 1:
                    continue
        # long flanking blocks stay fixed; only their trailing/leading
        # max_gap bases enter the window (reference: IndelRefine.h:175-205)
        q0, t0, ln0 = seg.blocks[lo]
        q0 += trim0
        t0 += trim0
        qe_b, te_b, ln_b = seg.blocks[hi]
        q1, t1 = qe_b + keep1, te_b + keep1
        if q1 <= q0 or t1 <= t0:
            continue
        if q1 - q0 < opts.refine_band or t1 - t0 < opts.refine_band:
            # tiny window: the reference falls back to the linear
            # one-gap aligner (IndelRefine.h:344-357), full window
            job = GapJob(read[q0:q1], chrom[t0:t1],
                         key_prefix + (lo, hi, q0, t0, trim0, keep1))
            job.band = opts.refine_band
            jobs.append(job)
            continue
        # band must cover the path's MAX intermediate diagonal offset,
        # not just the net drift (an existing +m then -m indel pair has
        # net drift 0 but wanders m off the rectangle diagonal); the
        # reference's shaped band follows the path with halfwidth k
        # (IndelRefine.h:230-330) — our rectangular band is its superset
        maxoff = 0
        for b in range(lo, hi + 1):
            bq, bt, _bl = seg.blocks[b]
            off = (bq - q0) - (bt - t0)
            maxoff = max(maxoff, abs(off))
        band = opts.refine_band + maxoff
        # first window base (a flank-block match) is force-paired at
        # zero score (IndelRefine.h:674); pass the SHIFTED window to the
        # refine DP, splice_refined_blocks prepends the (q0, t0, 1) block
        job = GapJob(read[q0 + 1:q1], chrom[t0 + 1:t1],
                     key_prefix + (lo, hi, q0, t0, trim0, keep1))
        job.band = band
        job.refine = True
        job.path = _job_path(np.asarray(seg.blocks, np.int64), lo, hi,
                             trim0, keep1, q0, t0)
        jobs.append(job)
    return jobs


def _job_path(bl: np.ndarray, lo: int, hi: int, trim0: int, keep1: int,
              q0: int, t0: int) -> np.ndarray:
    """Job-local block path of a refine region: blocks[lo..hi] with the
    first trimmed to its last max_gap bases (trim0) and the last to its
    first keep1, shifted so the forced first pair (q0, t0) is the DP
    origin.  Feeds the shaped-band host DP's per-row windows."""
    pb = bl[lo:hi + 1].copy()
    pb[0, 0] += trim0 + 1
    pb[0, 1] += trim0 + 1
    pb[0, 2] -= trim0 + 1
    pb[-1, 2] = keep1 if hi > lo else pb[-1, 2]
    pb[:, 0] -= q0 + 1
    pb[:, 1] -= t0 + 1
    return pb


def splice_refined_blocks(seg, jobs: list) -> None:
    """Rebuild seg.blocks from the tiled region plan (reference:
    IndelRefine.h:133-230, 765-780): each planned region is replaced by
    its retained start-flank piece + its re-aligned window blocks (the
    forced first pair prepended for refine-DP jobs); the end block's
    remainder flows into the next region or is emitted as-is.  Regions
    without a job (the provably-identity fast path) keep their original
    blocks, clipped to the same tiling cuts."""
    plan = getattr(seg, "refine_plan", None)
    if not plan:
        return
    jobmap = {}
    for job in jobs:
        jobmap[(job.key[3], job.key[4])] = job
    blocks = seg.blocks
    out: list = []

    def emit(bq, bt, bl, keep_zero=False):
        # merge contiguous pieces of the same original block back
        if bl < 0 or (bl == 0 and not keep_zero):
            return
        if out and out[-1][0] + out[-1][2] == bq and \
                out[-1][1] + out[-1][2] == bt:
            # contiguous: extend (a contiguous zero-length block adds
            # nothing either way)
            if bl > 0:
                out[-1] = (out[-1][0], out[-1][1], out[-1][2] + bl)
        elif bl > 0 or out:
            # keep_zero: zero-length blocks between two gap runs are the
            # reference's op-order markers (IndelRefine.h:715-745 emits
            # them): they keep a D-run-then-I-run from flipping to
            # I-then-D when the CIGAR is rebuilt from block gaps
            out.append((bq, bt, bl))

    i = 0
    consumed = 0     # bases of blocks[i] already emitted
    for (lo, hi, trim0, keep1) in plan:
        for b in range(i, lo):
            bq, bt, bl = blocks[b]
            s0 = consumed if b == i else 0
            emit(bq + s0, bt + s0, bl - s0)
        if lo > i:
            consumed = 0
        q0 = blocks[lo][0] + trim0
        t0 = blocks[lo][1] + trim0
        # start-flank piece of block lo not covered by the window
        emit(blocks[lo][0] + consumed, blocks[lo][1] + consumed,
             trim0 - consumed)
        job = jobmap.get((lo, hi))
        if job is not None and job.refine:
            # refine jobs are solved on the window shifted by one base;
            # prepend the forced (q0, t0) pair, merging when adjacent
            for (bq, bt, bl) in [(q0, t0, 1)] + [
                    (q0 + 1 + bq, t0 + 1 + bt, bl)
                    for (bq, bt, bl) in job_block_list(job)]:
                emit(bq, bt, bl, keep_zero=True)
        elif job is not None:
            emit(q0, t0, 0)   # no-op, keeps structure explicit
            for (bq, bt, bl) in job_block_list(job):
                emit(q0 + bq, t0 + bt, bl)
        else:
            # identity region (fast path): original blocks clipped to
            # the window cuts
            for b in range(lo, hi + 1):
                bq, bt, bl = blocks[b]
                s0 = trim0 if b == lo else 0
                e0 = keep1 if b == hi else bl
                emit(bq + s0, bt + s0, e0 - s0)
        if blocks[hi][2] > keep1:
            i = hi
            consumed = keep1
        else:
            i = hi + 1
            consumed = 0
    for b in range(i, len(blocks)):
        bq, bt, bl = blocks[b]
        s0 = consumed if b == i else 0
        emit(bq + s0, bt + s0, bl - s0)
    # boundary zero-length blocks carry no ordering information (no gap
    # on one side) — markers are only meaningful between two gap runs
    while out and out[0][2] == 0:
        out.pop(0)
    while out and out[-1][2] == 0:
        out.pop()
    a = np.asarray(out, np.int64)
    if len(a):
        q, t, ln = a[:, 0], a[:, 1], a[:, 2]
        # zero-length op-order markers are legal rows (ln == 0) and must
        # survive to blocks_to_op_arrays, which splits the junction gap
        # around them so a D-run-then-I-run doesn't flip to I-then-D
        if bool(np.all(ln >= 0)) and bool(
                np.all((q[1:] >= q[:-1] + ln[:-1])
                       & (t[1:] >= t[:-1] + ln[:-1]))):
            seg.blocks = out
            return
    clean = []
    pq = pt = -1
    for (bq, bt, bl) in out:
        if bq >= pq and bt >= pt and bl >= 0:
            clean.append((bq, bt, bl))
            pq, pt = bq + bl, bt + bl
    while clean and clean[0][2] == 0:
        clean.pop(0)
    while clean and clean[-1][2] == 0:
        clean.pop()
    seg.blocks = clean
