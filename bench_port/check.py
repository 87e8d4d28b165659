"""The output check that decides ``correct``: what the window's timed
path produced, held to the plain reference (reference/), after the
window has closed.

* The SAM records of every batch of the window: each batch's records
  name its reads, in order (``batches.wrong_reads``).
* The records of a sample of the window's reads, drawn from the seed,
  and of its longest read: each is consistent with the read and the
  genome (``sam.inconsistent``, reference/sam.py), and a read drawn from
  unique sequence is placed at its origin (``sam.misplaced``), by a
  primary record that aligns nearly all of the read
  (``sam.unaligned_pct``), ends near its source span's ends
  (``sam.ends_off``), scores nearly as well as the read's true alignment
  (``sam.as_short_pct``) and has a MAPQ above 0 (``sam.mapq0``).
* A sample of the device rounds' kernel calls (the shim's reservoir,
  drawn from the seed, and the largest call of each kernel), and in each
  a sample of its real problems with the largest: the chaining SDP's
  scores and back pointers (``k2.wrong_rows``, ``k7.wrong_rows``,
  reference/sdp.py), the banded and indel-refine DPs' tracebacks, each an
  optimal path (``k4.not_optimal``, ``k5.not_optimal``, reference/dp.py),
  and the one-gap DP's ops and gap, a valid path scoring the optimum,
  and its score, the optimum (``k6.not_optimal``, reference/one_gap.py).

Each number is printed beside its limit; ``correct`` holds when none is
above it.  The control (``control="bf16"``) puts the reference computed
in bfloat16, the precision below the f32 the kernels state, in the
kernels' place: it has to come out as not correct.
"""

from __future__ import annotations

import time

import numpy as np

from bench_port.harness import SAMPLE, log, rng_for, to_host
from bench_port.reference import dp, one_gap, sam, sdp

# limit of each number (see PERF.md for the readings each was set from)
LIMITS = {
    "batches.wrong_reads": 0,
    "sam.inconsistent": 0,
    "sam.misplaced": 0,
    "sam.unaligned_pct": 18,
    "sam.ends_off": 1500,
    "sam.as_short_pct": 16,
    "sam.mapq0": 2,
    "k2.wrong_rows": 0,
    "k7.wrong_rows": 0,
    "k4.not_optimal": 0,
    "k5.not_optimal": 0,
    "k6.not_optimal": 0,
}
SAMPLE_READS = 48        # reads whose records are checked, and the longest
DP_PROBLEMS = 24         # problems checked per DP call, and the largest
ONE_GAP_PROBLEMS = 12    # problems checked per one-gap call, and the largest
SDP_PROBLEMS = 2         # problems checked per SDP call, and the largest
SDP_MAX_ROWS = 16384     # the largest SDP problem checked (O(n^2) numpy)


def _primary(lines: list) -> dict:
    """{read name: [records]} of a batch's lines."""
    out: dict = {}
    for ln in lines:
        rec = sam.parse(ln)
        out.setdefault(rec["name"], []).append(rec)
    return out


def order_errors(window) -> tuple:
    """(batches whose records do not name their reads in order, reads of
    the window with no record)."""
    wrong = missing = 0
    for batch, lines in zip(window.batches, window.lines):
        names = []
        for ln in lines:
            n = ln.split("\t", 1)[0]
            if not names or names[-1] != n:
                names.append(n)
        want = [r.name for r in batch]
        if names != want:
            wrong += 1
            missing += len(set(want) - set(names))
    return wrong, missing


def _clear_of(repeats: np.ndarray, start: int, span: int) -> bool:
    return not bool(((repeats[:, 0] < start + span)
                     & (repeats[:, 1] > start)).any())


def sam_check(setup, window, seed: int) -> dict:
    """The sampled reads' records against reference/sam.py."""
    reads = [(k, r) for k, b in enumerate(window.batches) for r in b]
    rng = rng_for(seed, SAMPLE)
    pick = rng.choice(len(reads), size=min(SAMPLE_READS, len(reads)),
                      replace=False).tolist()
    longest = max(range(len(reads)), key=lambda i: len(reads[i][1].codes))
    if longest not in pick:
        pick.append(longest)
    chroms = dict(zip(setup.names, setup.seqs))
    by_batch: dict = {}
    bad = misplaced = mapq0 = 0
    worst = {"unaligned_pct": 0.0, "ends_off": 0, "as_short_pct": 0.0}
    for i in pick:
        k, read = reads[i]
        if k not in by_batch:
            by_batch[k] = _primary(window.lines[k])
        recs = by_batch[k].get(read.name, [])
        errs = [] if recs else ["no record"]
        mapped = [r for r in recs if not r["flag"] & 4]
        for r in mapped:
            errs += sam.problems(r, read.codes, chroms)
        if errs:
            bad += 1
            log(f"read {read.name}: {'; '.join(errs[:4])}")
        if not _clear_of(setup.repeats[read.chrom], read.start, read.span):
            continue
        prim = [r for r in mapped if not r["flag"] & (256 | 2048)
                and sam.placed(r, setup.names[read.chrom], read.start,
                               read.span, read.strand)]
        if not prim:
            misplaced += 1
            log(f"read {read.name} from {setup.names[read.chrom]}:"
                f"{read.start} {'-+'[read.strand == 0]} is placed at "
                + (", ".join(f"{r['rname']}:{r['pos']}" for r in mapped
                             if not r["flag"] & (256 | 2048)) or "none"))
            continue
        got = sam.truth(prim[0], len(read.codes), read.start, read.span,
                        read.true_as)
        for key in worst:
            worst[key] = max(worst[key], got[key])
        mapq0 += int(got["mapq"] == 0)
    return {"sam.inconsistent": bad, "sam.misplaced": misplaced,
            **{f"sam.{k}": v for k, v in worst.items()}, "sam.mapq0": mapq0,
            "sam.reads_checked": len(pick)}


def _unpack(row: np.ndarray) -> list:
    """Packed 2-bit ops (LEFT/DOWN/DIAG = 1/2/3, 0 = end), end-first."""
    codes = np.stack([(row >> s) & 3 for s in (0, 2, 4, 6)], 1).reshape(-1)
    end = np.flatnonzero(codes == 0)
    return codes[:end[0] if len(end) else len(codes)].tolist()


def _pick(rng, real: np.ndarray, size: np.ndarray, n: int) -> list:
    idx = np.flatnonzero(real)
    if not len(idx):
        return []
    out = rng.choice(idx, size=min(n, len(idx)), replace=False).tolist()
    big = int(idx[np.argmax(size[idx])])
    return out + ([big] if big not in out else [])


def dp_check(kind: str, calls: list, scoring: dict, rng,
             control: str | None) -> tuple:
    """(problems not optimal, problems checked) of K4 ("global") or K5
    ("refine") calls: each sampled problem's traceback must be a valid
    path whose score is the reference's optimum."""
    m, mm, ind = (scoring[k] for k in ("local_match", "local_mismatch",
                                       "local_indel"))
    bad = checked = 0
    for args, kw, out in calls:
        q, t, qlen, tlen = (to_host(a) for a in args[:4])
        kband = to_host(kw["kband"] if "kband" in kw else args[8])
        ops = to_host(out)
        real = (qlen > 0) | (tlen > 0)
        for b in _pick(rng, real, qlen + tlen, DP_PROBLEMS):
            qb, tb = q[b].astype(np.int64), t[b].astype(np.int64)
            ql, tl, kb = int(qlen[b]), int(tlen[b]), int(kband[b])
            opt = dp.optimum(kind, qb, tb, ql, tl, kb, m, mm, ind)
            path = (dp.traceback(kind, qb, tb, ql, tl, kb, m, mm, ind,
                                 dp.bf16) if control == "bf16"
                    else _unpack(ops[b]))
            got, ok = dp.rescore(kind, path, qb, tb, ql, tl, kb, m, mm, ind)
            checked += 1
            if not ok or got != opt:
                bad += 1
    return bad, checked


def _full(head: np.ndarray, tail: np.ndarray, n: int) -> np.ndarray:
    """A sequence of length n from its head and tail windows; the middle,
    which the one-gap DP never reads, as N (code 4)."""
    seq = np.full(n, 4, dtype=np.int64)
    h = min(n, len(head))
    seq[:h] = head[:h]
    z = min(n, len(tail))
    seq[n - z:] = tail[len(tail) - z:]
    return seq


def one_gap_check(calls: list, scoring: dict, rng,
                  control: str | None) -> tuple:
    """(problems not optimal, problems checked) of K6 calls: each sampled
    problem's ops and gap must be a valid one-gap path whose score, and
    the score the kernel returns, are the reference's optimum
    (reference/one_gap.py)."""
    m, mm, ind = (scoring[k] for k in ("local_match", "local_mismatch",
                                       "local_indel"))
    bad = checked = 0
    for args, _kw, out in calls:
        qh, th, qt, tt, qlen, tlen, kb = (to_host(a) for a in args[:7])
        ops, jump, score = (to_host(o) for o in out)
        real = ~((qlen == 1) & (tlen == 4) & (kb == 1))
        for b in _pick(rng, real, np.minimum(qlen, tlen), ONE_GAP_PROBLEMS):
            q = _full(qh[b], qt[b], int(qlen[b]))
            t = _full(th[b], tt[b], int(tlen[b]))
            opt = one_gap.optimum(q, t, m, mm, ind, int(kb[b]))
            row = ops[b][:np.flatnonzero(ops[b] < 0)[0]] \
                if (ops[b] < 0).any() else ops[b]
            got, ok = one_gap.rescore(row[::-1].tolist(), int(jump[b]), q, t,
                                      m, mm, ind, int(kb[b]))
            said = float(score[b])
            if control == "bf16":
                said = one_gap.optimum(q, t, m, mm, ind, int(kb[b]),
                                       rnd=dp.bf16)
            checked += 1
            bad += int(opt is None or not ok or got != opt or said != opt)
    return bad, checked


def sdp_check(calls: list, scoring: dict, rng, control: str | None,
              windowed: bool) -> tuple:
    """(rows wrong, rows checked) of K2 (or K7) calls: each sampled
    problem's V, back pointers and lanes against reference/sdp.py (K7's
    far back pointers are sentinels: its V alone is held there)."""
    slope, inter = sdp.pwl_params(scoring["gap_extend"], scoring["gap_root"])
    gaps = (slope, inter, float(scoring["gap_ceiling1"]),
            float(scoring["gap_ceiling2"]))
    bad = checked = 0
    for args, kw, out in calls:
        qS, qE, tS, tE, score, l1, l2, valid = (to_host(a)
                                                for a in args[:8])
        V, bp, lane = (to_host(o) for o in out)
        n = valid.sum(axis=1)
        real = (n > 0) & (n <= SDP_MAX_ROWS)
        for b in _pick(rng, real, n, SDP_PROBLEMS):
            rows = np.flatnonzero(valid[b])
            if not len(rows) or rows[-1] != len(rows) - 1:
                bad += 1             # the valid rows are not a prefix
                continue
            r = slice(0, len(rows))
            ch = sdp.Chain(qS[b, r], qE[b, r], tS[b, r], tE[b, r],
                           score[b, r], l1[b, r], l2[b, r], gaps)
            Vb = V[b, r]
            if control == "bf16":
                Vb = ch.scores(rnd=lambda x: dp.bf16(x).astype(np.float32))
            if windowed:
                ref = ch.scores()
                bad += int((Vb != ref).sum())
            else:
                bad += ch.bad_rows(Vb, bp[b, r], lane[b, r])
            checked += len(rows)
    return bad, checked


def kernel_check(capture, scoring: dict, seed: int,
                 control: str | None) -> dict:
    rng = rng_for(seed, SAMPLE + 100)
    out = {}
    for name, key, fn in (
            ("k4_global", "k4", lambda c: dp_check("global", c, scoring, rng,
                                                   control)),
            ("k5_refine", "k5", lambda c: dp_check("refine", c, scoring, rng,
                                                   control)),
            ("k2_sdp", "k2", lambda c: sdp_check(c, scoring, rng, control,
                                                 False)),
            ("k7_windowed", "k7", lambda c: sdp_check(c, scoring, rng,
                                                      control, True)),
            ("k6_one_gap", "k6", lambda c: one_gap_check(c, scoring, rng,
                                                         control))):
        calls = capture.checked_calls(name) if name in capture.sample else []
        t = time.perf_counter()
        bad, n = fn(calls)
        what = "wrong_rows" if key in ("k2", "k7") else "not_optimal"
        out[f"{key}.{what}"] = bad
        out[f"{key}.checked"] = n
        log(f"{key}: {len(calls)} calls of {capture.calls.get(name, 0)}, "
            f"{n} {'rows' if what == 'wrong_rows' else 'problems'} checked, "
            f"{bad} wrong, {time.perf_counter() - t:.1f} s")
    return out


def run(setup, window, capture, seed: int, control: str | None = None):
    """(correct, reads with no record, [(number, value, limit)])."""
    t = time.perf_counter()
    wrong, missing = order_errors(window)
    found = {"batches.wrong_reads": wrong}
    found.update(sam_check(setup, window, seed))
    found.update(kernel_check(capture, setup.scoring, seed, control))
    compared = [(k, found[k], LIMITS[k]) for k in LIMITS]
    correct = all(v <= lim for _k, v, lim in compared)
    log(f"output check in {time.perf_counter() - t:.1f} s")
    return correct, missing, compared
