#!/usr/bin/env python3
"""One traced window of a contig cell, held whole to the plain references.

    python3 tools/contig_compare.py --workload contig.draft --seed 7 \
        --seconds 51

runs ``bench_port/run.py`` with ``--trace 1`` in this process (its output
as it is; its set-up, window and output check are bench_port.harness's
``Setup`` and ``Window``) and keeps, while the window runs, every
chaining problem the windowed kernel solved (the chain driver's rounds'
problems past the top blocked bucket, shard children included), with
its final V, back pointers and lanes: after the host has resolved the
kernel's FAR sentinels.  Then, on the run's device:

* every such problem against bench_port/reference/chain_torch.py, the
  whole chaining SDP with every predecessor: rows whose V is not the
  reference's exactly, and rows whose back pointer and lane do not
  attain it;
* every contig of the window (the output check samples 48) against
  bench_port/reference/sam.py: its records' consistency (``problems``),
  its primary's placement (``placed``) and how far the primary falls
  short of the contig's true alignment (``truth``), and the same for
  the primary with the supplementary records placed beside it (a chain
  split at a long stretch with no anchors, such as the genome's
  satellite array, is one record a piece); and how many of the contigs
  the output check's placement checks could read (those clear of the
  genome's salted repeats).

The last line of standard output is one JSON object with those counts
and the worst readings beside the output check's limits; ``ok`` holds
when every chaining row is exact and attained and every contig is
consistent, placed and, counting all its placed records, within the
limits.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class WindowedProblems:
    """A wrapper of the chain driver's round (``_solve_batch``) that keeps
    each windowed problem's fragments and final answer while ``on``."""

    def __init__(self, driver):
        self.driver, self.on, self.kept = driver, False, []
        self._lock = threading.Lock()
        self._orig = driver._solve_batch

    def __enter__(self):
        def solve(problems, *a):
            out = self._orig(problems, *a)
            if self.on:
                top = self.driver._BUCKETS[-1]
                got = [tuple(x.copy() for x in (
                    p.qS, p.qE, p.tS, p.tE, p.score, p.lane1, p.lane2,
                    p.V, p.bp, p.lane)) for p in problems if len(p.qS) > top]
                with self._lock:
                    self.kept += got
            return out
        self.driver._solve_batch = solve
        return self

    def __exit__(self, *exc):
        self.driver._solve_batch = self._orig
        return False


def chain_check(kept: list, scoring: dict, device: str) -> dict:
    """The kept problems against chain_torch, in groups of similar size."""
    from bench_port.reference import chain_torch, sdp

    slope, inter = sdp.pwl_params(scoring["gap_extend"], scoring["gap_root"])
    gaps = (slope, inter, float(scoring["gap_ceiling1"]),
            float(scoring["gap_ceiling2"]))
    t = time.perf_counter()
    out = {"problems": len(kept), "rows": 0, "v_wrong_rows": 0,
           "bad_rows": 0, "best_wrong": 0, "largest": 0}
    order = sorted(range(len(kept)), key=lambda k: len(kept[k][0]))
    for g in range(0, len(order), 64):
        group = [kept[k] for k in order[g:g + 64]]
        res = chain_torch.solve_many([p[:7] for p in group], gaps, device,
                                     ports=[p[7:] for p in group])
        for p, r in zip(group, res):
            V = p[7]
            out["rows"] += len(V)
            out["largest"] = max(out["largest"], len(V))
            out["v_wrong_rows"] += int((r["V"] != V).sum())
            out["bad_rows"] += len(r["bad_rows"])
            out["best_wrong"] += int(len(V) > 0
                                     and float(V.max()) != r["best"])
    out["seconds"] = time.perf_counter() - t
    return out


def _records(recs: list) -> list:
    """A short form of a read's records: reference, position, flag,
    MAPQ, reference span and aligned read bases of each."""
    from bench_port.reference import sam

    return [[r["rname"], r["pos"], r["flag"], r["mapq"], r["tspan"],
             sum(int(n) for n, op in sam._CIGAR.findall(r["cigar"])
                 if op in "=XIM")] for r in recs]


def sam_check_all(setup, window) -> dict:
    """Every read of the window against reference/sam.py; ``over`` lists
    each read past one of the output check's limits, with its source and
    its records."""
    from bench_port import check
    from bench_port.reference import sam

    t = time.perf_counter()
    chroms = dict(zip(setup.names, setup.seqs))
    out = {"contigs": 0, "inconsistent": 0, "misplaced": 0,
           "clear_of_repeats": 0, "misplaced_clear": 0, "mapq0": 0,
           "split": 0, "over": []}
    worst = {"unaligned_pct": 0.0, "ends_off": 0, "as_short_pct": 0.0}
    whole = {"unaligned_pct": 0.0, "ends_off": 0, "as_short_pct": 0.0}
    seen = set()
    for batch, lines in zip(window.batches, window.lines):
        recs = check._primary(lines)
        for read in batch:
            if read.name in seen:            # a pool that wrapped round
                continue
            seen.add(read.name)
            out["contigs"] += 1
            mine = recs.get(read.name, [])
            mapped = [r for r in mine if not r["flag"] & 4]
            errs = [] if mine else ["no record"]
            for r in mapped:
                errs += sam.problems(r, read.codes, chroms)
            out["inconsistent"] += int(bool(errs))
            clear = check._clear_of(setup.repeats[read.chrom], read.start,
                                    read.span)
            out["clear_of_repeats"] += int(clear)
            prim = [r for r in mapped if not r["flag"] & (256 | 2048)
                    and sam.placed(r, setup.names[read.chrom], read.start,
                                   read.span, read.strand)]
            got = sam.truth(prim[0], len(read.codes), read.start, read.span,
                            read.true_as) if prim else {}
            if not prim or any(got[k] > check.LIMITS[f"sam.{k}"]
                               for k in worst):
                out["over"].append({
                    "name": read.name, "source": [
                        setup.names[read.chrom], read.start, read.span,
                        read.strand], "clear": clear,
                    **{k: got.get(k) for k in worst},
                    "records": _records(mine)})
            if not prim:
                out["misplaced"] += 1
                out["misplaced_clear"] += int(clear)
                continue
            for k in worst:
                worst[k] = max(worst[k], got[k])
            out["mapq0"] += int(got["mapq"] == 0)
            # the primary with the supplementary records placed beside it
            # (lra splits a chain at a gap of more than 50 kb of masked
            # anchors: each piece a record, the chain's last one primary)
            pieces = [r for r in mapped if not r["flag"] & 256
                      and sam.placed(r, setup.names[read.chrom], read.start,
                                     read.span, read.strand)]
            out["split"] += int(len(pieces) > 1)
            span = [sam.truth(r, len(read.codes), read.start, read.span, 0)
                    for r in pieces]
            t0 = min(r["pos"] - 1 for r in pieces)
            t1 = max(r["pos"] - 1 + r["tspan"] for r in pieces)
            got = {"unaligned_pct": 100.0 - sum(100.0 - g["unaligned_pct"]
                                                for g in span),
                   "ends_off": max(abs(t0 - read.start),
                                   abs(t1 - read.start - read.span)),
                   "as_short_pct": 100.0 * (read.true_as - sum(
                       int(r["tags"].get("AS", 0)) for r in pieces))
                   / read.span}
            for k in whole:
                whole[k] = max(whole[k], got[k])
    out.update(worst)
    out["all_records"] = whole
    out["seconds"] = time.perf_counter() - t
    return out


def main(argv=None, **run_kw) -> int:
    """``run_kw`` goes to ``bench_port.run.main`` (the CPU tests pass a
    device, configuration and traffic of their own)."""
    # the recorder and devstats take their switch at the program's import
    os.environ["LRA_TPU_DEVSTATS"] = "1"
    from bench_port import check, harness, run
    from lra_tpu_torch.chain import driver

    seen: dict = {}
    check_run = check.run
    window_run = harness.Window.run
    keep = WindowedProblems(driver)

    def checked(setup, window, *a, **kw):
        seen["setup"], seen["window"] = setup, window
        return check_run(setup, window, *a, **kw)

    def in_window(self):
        keep.on = True
        try:
            window_run(self)
        finally:
            keep.on = False

    check.run = checked
    harness.Window.run = in_window
    try:
        with keep:
            rc = run.main([*(sys.argv[1:] if argv is None else argv),
                           "--trace", "1"], **run_kw)
    finally:
        check.run = check_run
        harness.Window.run = window_run
    if rc != 0 or "window" not in seen:
        return rc
    setup, window = seen["setup"], seen["window"]
    from lra_tpu_torch.utils import devstats

    rounds = devstats.report().get("chain_sdp", {})
    harness.log("the window's chaining rounds: " + ", ".join(
        f"{k} {rounds.get(k, 0)}" for k in ("rounds", "win_jobs", "win_rows",
                                            "far_sentinels", "shards")))
    chains = chain_check(keep.kept, setup.scoring, setup.device)
    harness.log(f"chain_torch: {json.dumps(chains)}")
    sams = sam_check_all(setup, window)
    over = sams.pop("over")
    harness.log(f"every contig: {json.dumps(sams)}")
    for o in over:
        harness.log(f"past a limit: {json.dumps(o)}")
    sams["over_limits"] = len(over)
    limits = {k: check.LIMITS[f"sam.{k}"] for k in
              ("unaligned_pct", "ends_off", "as_short_pct")}
    ok = (chains["problems"] > 0 and chains["v_wrong_rows"] == 0
          and chains["bad_rows"] == 0 and sams["inconsistent"] == 0
          and sams["misplaced"] == 0
          and all(sams["all_records"][k] <= lim
                  for k, lim in limits.items()))
    chains["far_sentinels"] = rounds.get("far_sentinels", 0)
    print(json.dumps({"ok": ok, "chain": chains, "contigs": sams,
                      "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
