"""The gap-align round's columnar gap table (pipeline/gap_align.GapTable):
the batch-wide splice against a per-segment reference splice, the rows
the assembly walk emits against an independent walk over the same
chains, and solve_gap_jobs on a table against the same gaps as a GapJob
list (the same buckets, rows and blocks).  Tolerance: exact."""

import numpy as np
import pytest
import torch

from lra_tpu_torch import preset
from lra_tpu_torch.align.segment import SegGroup, Segment
from lra_tpu_torch.chain.cleaners import AnchorChain
from lra_tpu_torch.io.genome import Genome
from lra_tpu_torch.pipeline import gap_align as ga
from lra_tpu_torch.pipeline.gap_align import GapJob, GapTable
from lra_tpu_torch.pipeline.highacc import (ReadState, _assemble_segments,
                                            splice_gap_blocks)
from lra_tpu_torch.seq import revcomp
from lra_tpu_torch.utils import devstats

torch.set_num_threads(2)


# ------------------------------------------------------------ splice ---

def reference_splice(seg, jobs: list) -> None:
    """The per-segment splice the batch-wide one replaced: solved gap
    blocks (relative coords) into the segment's block list, then (q, t)
    order restored."""
    arr_parts = []
    for job in jobs:
        q_off, t_off = job.key[3], job.key[4]
        bl = job.blocks
        if bl is None or len(bl) == 0:
            continue
        if isinstance(bl, np.ndarray):
            a = bl.astype(np.int64)
            a[:, 0] += q_off
            a[:, 1] += t_off
            arr_parts.append(a)
            continue
        for (bq, bt, ln) in bl:
            seg.blocks.append((q_off + bq, t_off + bt, ln))
    if arr_parts:
        own = np.asarray(seg.blocks, np.int64).reshape(-1, 3) \
            if seg.blocks else np.zeros((0, 3), np.int64)
        a = np.concatenate([own] + arr_parts)
    elif len(seg.blocks) > 1:
        a = np.asarray(seg.blocks, np.int64)
    else:
        return
    if len(a) <= 1:
        seg.blocks = list(map(tuple, a.tolist()))
        return
    q, t, ln = a[:, 0], a[:, 1], a[:, 2]
    if bool(np.all((q[1:] >= q[:-1] + ln[:-1])
                   & (t[1:] >= t[:-1] + ln[:-1]))):
        if arr_parts:
            seg.blocks = list(map(tuple, a.tolist()))
        return
    a = a[np.lexsort((t, q))]
    q, t, ln = a[:, 0], a[:, 1], a[:, 2]
    if bool(np.all((q[1:] >= q[:-1] + ln[:-1])
                   & (t[1:] >= t[:-1] + ln[:-1]))):
        seg.blocks = list(map(tuple, a.tolist()))
        return
    out = []
    pq = pt = -1
    for (bq, bt, bl) in a.tolist():
        if bq >= pq and bt >= pt:
            out.append((bq, bt, bl))
            pq, pt = bq + bl, bt + bl
    seg.blocks = out


def _random_segment(rng, case: str):
    """(own blocks, [(q_off, t_off, qlen, tlen, blocks)]) of one segment:
    anchors with gaps between them, each gap's blocks inside its box."""
    n = int(rng.integers(1, 7))
    q = t = int(rng.integers(0, 50))
    own, gaps = [], []
    for k in range(n):
        ln = int(rng.integers(1, 20))
        own.append((q, t, ln))
        q, t = q + ln, t + ln
        if k == n - 1:
            break
        gq, gt = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        if rng.random() < 0.8:
            blocks, bq, bt = [], 0, 0
            while True:
                bq += int(rng.integers(0, 4))
                bt += int(rng.integers(0, 4))
                bl = int(rng.integers(1, 6))
                if bq + bl > gq or bt + bl > gt:
                    break
                blocks.append((bq, bt, bl))
                bq, bt = bq + bl, bt + bl
            kind = rng.integers(0, 3) if case == "empty_none_mixed" else (
                rng.integers(0, 2) if case == "list_and_array" else 1)
            if kind == 0:
                blocks = None if rng.random() < 0.5 else []
            elif kind == 1:
                blocks = np.asarray(blocks, np.int32).reshape(-1, 3)
            gaps.append((q, t, gq, gt, blocks))
        q, t = q + gq, t + gt
    if case in ("needs_sort", "needs_drop") and len(own) > 1:
        # the segment's own blocks out of order (as the slow walk's and
        # the big gaps' appended blocks leave them)
        own = own[1:] + own[:1]
    if case == "needs_drop" and own:
        # a block overlapping another: out of order even after the sort
        bq, bt, bl = own[int(rng.integers(0, len(own)))]
        own.append((bq + 1, bt + int(rng.integers(2, 4)), bl + 3))
    if case != "monotone" and rng.random() < 0.5:
        own = np.asarray(own, np.int64).reshape(-1, 3)
    return own, gaps


def _unique_starts(own, gaps) -> bool:
    """No two blocks of the segment start at the same (q, t) (real gaps
    lie between anchors, so only a planted overlap could)."""
    starts = [(int(b[0]), int(b[1])) for b in own]
    for q0, t0, _gq, _gt, bl in gaps:
        if bl is not None:
            starts += [(q0 + int(b[0]), t0 + int(b[1])) for b in bl]
    return len(starts) == len(set(starts))


@pytest.mark.parametrize("case", ["monotone", "needs_sort", "needs_drop",
                                  "empty_none_mixed", "list_and_array"])
def test_splice_equals_per_segment_reference(case):
    rng = np.random.default_rng(["monotone", "needs_sort", "needs_drop",
                                 "empty_none_mixed",
                                 "list_and_array"].index(case))
    read = np.zeros(4096, np.uint8)
    ref = (np.zeros(4096, np.uint8), 0)
    for trial in range(40):
        table = GapTable()
        entries, ref_segs, ref_jobs = [], [], []
        n_solved = []
        for si in range(int(rng.integers(1, 4))):
            for zi in range(int(rng.integers(0, 4))):
                own, gaps = _random_segment(rng, case)
                while not _unique_starts(own, gaps):
                    own, gaps = _random_segment(rng, case)
                key3 = (si, 0, zi)
                seg = Segment(own if isinstance(own, np.ndarray)
                              else list(own), 0, 0, 4096)
                oseg = Segment(list(map(tuple, np.asarray(
                    own, np.int64).reshape(-1, 3).tolist())), 0, 0, 4096)
                jobs = []
                for q0, t0, gq, gt, bl in gaps:
                    table.add_one(key3, q0, q0 + gq, t0, t0 + gt, read, ref)
                    jobs.append(GapJob(read[q0:q0 + gq], ref[0][t0:t0 + gt],
                                       key3 + (q0, t0), blocks=bl))
                    n_solved.append(np.asarray(
                        [] if bl is None else bl, np.int64).reshape(-1, 3))
                entries.append((key3, seg))
                ref_segs.append(oseg)
                ref_jobs.append(jobs)
        table.close()
        counts = np.array([len(b) for b in n_solved], np.int64)
        table.boff = np.concatenate([[0], np.cumsum(counts)])
        table.blocks = (np.concatenate(n_solved) if n_solved
                        else np.zeros((0, 3), np.int64))
        splice_gap_blocks(entries, table)
        for (key3, seg), oseg, jobs in zip(entries, ref_segs, ref_jobs):
            reference_splice(oseg, jobs)
            assert isinstance(seg.blocks, np.ndarray)
            assert seg.blocks.dtype == np.int64
            assert list(map(tuple, seg.blocks.tolist())) == \
                [tuple(int(v) for v in b) for b in oseg.blocks], (case, key3)


# ---------------------------------------------------------- emission ---

class _Ch:
    num_anchors = 0
    value = 0.0


class _Ext:
    def __init__(self, chrom):
        self.chrom = chrom


def _walk_reference(read, chrom, vq, vt, vl, key3, opts):
    """The gap jobs and blocks of one segment by a plain per-anchor walk
    (overlaps clipped, as the assembly walk does; no big gaps)."""
    diag_ok = ga.diag_gap_guard(opts)
    blocks, jobs = [], []
    pqe = pte = None
    for bq, bt, bl in zip(vq, vt, vl):
        if pqe is not None:
            if bq < pqe or bt < pte:
                shift = max(pqe - bq, pte - bt)
                bq, bt, bl = bq + shift, bt + shift, bl - shift
                if bl <= 0:
                    continue
            rgap, tgap = bq - pqe, bt - pte
            if rgap > 0 and tgap > 0:
                if diag_ok and rgap == tgap and int(np.count_nonzero(
                        read[pqe:bq] != chrom[pte:bt])) <= 1:
                    blocks.append((pqe, pte, rgap))
                else:
                    jobs.append((key3 + (pqe, pte), read[pqe:bq],
                                 chrom[pte:bt]))
        blocks.append((bq, bt, bl))
        pqe, pte = bq + bl, bt + bl
    return blocks, jobs


def _random_chain(rng, chrom_codes, t_start, clip: bool):
    """Anchors (strand frame) and a read that matches the reference at
    them: gaps of every kind between, some trivial diagonals (equal
    lengths, at most one mismatch), some zero-length on one side."""
    vq, vt, vl, parts = [], [], [], []
    q, t = 0, t_start
    for k in range(int(rng.integers(2, 24))):
        ln = int(rng.integers(8, 30))
        if k:
            kind = rng.integers(0, 4)
            gq = int(rng.integers(1, 40))
            if kind == 0:           # equal lengths: trivial or not
                gt = gq
            elif kind == 1:         # nothing on one side
                gq, gt = (0, gq) if rng.random() < 0.5 else (gq, 0)
            else:
                gt = max(0, gq + int(rng.integers(-6, 7)))
            seg_t = chrom_codes[t:t + gt].copy()
            if gq == gt:
                piece = seg_t.copy()
                for _ in range(int(rng.integers(0, 3))):
                    piece[int(rng.integers(0, gq))] ^= 1
            else:
                piece = rng.integers(0, 4, gq).astype(np.uint8)
            parts.append(piece)
            q, t = q + gq, t + gt
        vq.append(q)
        vt.append(t)
        vl.append(ln)
        parts.append(chrom_codes[t:t + ln].copy())
        q, t = q + ln, t + ln
    if clip and len(vq) > 2:
        # an anchor that overlaps its predecessor: the walk clips it
        j = int(rng.integers(1, len(vq)))
        vq[j] -= 3
        vt[j] -= 3
        vl[j] += 3
    return (np.array(vq), np.array(vt), np.array(vl),
            np.concatenate(parts).astype(np.uint8))


@pytest.mark.parametrize("strand", [0, 1])
@pytest.mark.parametrize("clip", [False, True])
def test_emission_equals_walk(strand, clip):
    rng = np.random.default_rng(10 * strand + int(clip))
    opts = preset("ont")
    genome = Genome.from_seqs([
        ("chr1", rng.integers(0, 4, 20000).astype(np.uint8)),
        ("chr2", rng.integers(0, 4, 20000).astype(np.uint8))])
    starts = genome.starts()
    for trial in range(12):
        table = GapTable()
        group = SegGroup()
        chrom = int(rng.integers(0, 2))
        chrom_codes = genome.codes[starts[chrom]:genome.ends[chrom]]
        vq, vt, vl, read_s = _random_chain(rng, chrom_codes,
                                           int(rng.integers(0, 5000)), clip)
        codes = read_s if strand == 0 else revcomp(read_s)
        st = ReadState("r", codes)
        st.rc = revcomp(codes)
        L = len(codes)
        qpos = vq if strand == 0 else L - vq - vl
        order = np.argsort(-qpos, kind="stable")    # end-first
        ac = AnchorChain(qpos[order].astype(np.int64),
                         vt[order].astype(np.int64),
                         vl[order].astype(np.int64),
                         np.full(len(vq), strand, np.uint8),
                         np.zeros(len(vq), np.int64))
        ac.second_sdp_value = 0.0
        _assemble_segments(st, _Ch, ac, [_Ext(chrom)], genome, opts, group,
                           table, 3, 1, None, [])
        blocks, expected = _walk_reference(read_s, chrom_codes,
                                           vq.tolist(), vt.tolist(),
                                           vl.tolist(), (3, 1, 0), opts)
        assert len(group.segments) == 1
        seg = group.segments[0]
        assert [tuple(int(v) for v in b) for b in seg.blocks] == blocks
        table.close()
        assert table.n == len(expected)
        slow = any(b < a for a, b in zip(
            np.add(vq, vl)[:-1].tolist(), vq[1:].tolist())) or any(
            b < a for a, b in zip(np.add(vt, vl)[:-1].tolist(),
                                  vt[1:].tolist()))
        for r, (key, q, t) in enumerate(expected):
            assert table.keys[table.seg[r]] + (int(table.q0[r]),
                                               int(table.t0[r])) == key
            assert np.array_equal(table.q(r), q)
            assert np.array_equal(table.t(r), t)
            assert bool(table.checked[r])
            # the slow walk's rows come through the per-row adapter
            assert bool(table.adapted[r]) == slow


# ------------------------------------------------------------- solve ---

def _solve_world(seed: int):
    """A gap table and the same gaps as GapJobs: trivial diagonals left
    for the round to find, equal-length gaps with mismatches, empty gaps,
    in-regime gaps of several size classes, one-long-gap rows (K6)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 60000).astype(np.uint8)
    reads = [rng.integers(0, 4, 6000).astype(np.uint8) for _ in range(3)]
    rows = []
    for k in range(160):
        r = int(rng.integers(0, 3))
        shift = int(rng.integers(0, 2)) * 30000
        kind = k % 6
        q0 = int(rng.integers(0, 5000))
        t0 = int(rng.integers(0, 29000))
        if kind == 0:               # trivial diagonal (<= 1 mismatch)
            g = int(rng.integers(1, 40))
            reads[r][q0:q0 + g] = genome[shift + t0:shift + t0 + g]
            if rng.random() < 0.5:
                reads[r][q0 + int(rng.integers(0, g))] ^= 1
            gq = gt = g
        elif kind == 1:             # equal lengths, not trivial
            gq = gt = int(rng.integers(3, 60))
        elif kind == 2:             # empty on one side
            gq, gt = (0, 7) if rng.random() < 0.5 else (5, 0)
        elif kind == 3:             # one long gap (K6)
            gq, gt = int(rng.integers(2, 12)), int(rng.integers(150, 400))
            if rng.random() < 0.5:
                gq, gt = gt, gq
        else:                       # in regime, several size classes
            gq = int(rng.integers(1, 300))
            gt = max(1, gq + int(rng.integers(-8, 9)))
        rows.append((r, shift, q0, q0 + gq, t0, t0 + gt, kind == 0 and
                     rng.random() < 0.3))
    table = GapTable()
    jobs = []
    for k, (r, shift, q0, q1, t0, t1, checked) in enumerate(rows):
        key3 = (r, 0, k // 40)
        if k % 40 < 30:
            table.add(key3, np.array([q0]), np.array([q1]), np.array([t0]),
                      np.array([t1]), reads[r], (genome, shift),
                      checked=False)
        else:
            table.add_one(key3, q0, q1, t0, t1, reads[r], (genome, shift),
                          checked=False)
        jobs.append(GapJob(reads[r][q0:q1],
                           genome[shift + t0:shift + t1], key3 + (q0, t0)))
    return table, jobs


def _record_launches(monkeypatch, calls: list):
    for name in ("banded_global_traced_packed", "banded_refine_traced_packed",
                 "one_gap_traced"):
        orig = getattr(ga, name)

        def rec(*args, _orig=orig, _name=name, **kw):
            calls.append((_name, [np.asarray(a).copy()
                                  for a in list(args) + list(kw.values())
                                  if hasattr(a, "shape")],
                          [a for a in args if isinstance(a, int)]))
            return _orig(*args, **kw)
        monkeypatch.setattr(ga, name, rec)


@pytest.mark.parametrize("use_device", [True, False])
def test_solve_table_equals_job_list(use_device, monkeypatch):
    opts = preset("ont")
    monkeypatch.setattr(devstats, "ENABLED", True)
    got = {}
    for what in ("table", "jobs"):
        table, jobs = _solve_world(5)
        calls: list = []
        _record_launches(monkeypatch, calls)
        devstats.reset()
        ga.solve_gap_jobs(table if what == "table" else jobs, opts,
                          use_device, device="cpu")
        (tag, kw), = devstats.EVENTS
        devstats.reset()
        monkeypatch.undo()
        monkeypatch.setattr(devstats, "ENABLED", True)
        blocks = ([table.blocks[table.boff[i]:table.boff[i + 1]].tolist()
                   for i in range(table.n)] if what == "table" else
                  [ga.job_block_list(j) for j in jobs])
        got[what] = (calls, blocks, kw)
    (c1, b1, kw1), (c2, b2, kw2) = got["table"], got["jobs"]
    # the same buckets (kernel, K, B, S) with the same rows in order
    assert [(n, ints) for n, _, ints in c1] == [(n, ints) for n, _, ints in c2]
    for (_, a1, _), (_, a2, _) in zip(c1, c2):
        assert len(a1) == len(a2)
        for x, y in zip(a1, a2):
            assert x.shape == y.shape and np.array_equal(x, y)
    if use_device:
        assert {n for n, _, _ in c1} >= {"banded_global_traced_packed",
                                         "one_gap_traced"}
    assert b1 == b2
    assert any(len(b) for b in b1)
    for c in ("buckets", "jobs", "small_jobs", "host_rows"):
        assert kw1[c] == kw2[c], c
    assert kw1["table_rows"] + kw1["object_rows"] == kw1["jobs"]
    assert kw2["table_rows"] == 0 and kw2["object_rows"] == kw2["jobs"]
    if use_device:
        assert kw1["table_rows"] > 0
