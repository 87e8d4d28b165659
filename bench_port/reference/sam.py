"""Plain reference check of SAM records against the reads and the genome,
in numpy.  Written from the SAM specification and lra's tag definitions
(lra's Alignment.h, as lra_tpu_torch/io/sam.py and align/cigar.py state
them); no code of the program is called.

A mapped record is consistent when its CIGAR spells the read against
the reference: clips and query-consuming runs add up to the read, every
``=`` base matches, every ``X`` base differs, the reference span lies in
the chromosome and equals field 9; SEQ is the read on the record's
strand (the clipped part only, under hard clips); and its tags are those
its CIGAR gives: NX mismatched bases, ND / NI deletion / insertion runs,
TD / TI their bases, NM = NX + ND + NI (lra counts gap runs), AS the
integer part of lra's float score of the runs.

``truth`` holds a read's primary record to what the simulation knows of
the read: its source span and the score of its true alignment.
"""

from __future__ import annotations

import re

import numpy as np

_CIGAR = re.compile(r"(\d+)([=XIDSHM])")
_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
_LOG = np.log(np.arange(1, 10002, 5).astype(np.float64)).astype(np.float32)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


def run_score(ops: list) -> float:
    """lra's alignment value of a run list, accumulated in float32 in run
    order: an '=' run +n, an 'X' run -n, a gap run of n bases -n up to
    20, -3 log(1 + 5 floor((n - 1) / 5)) - 1 up to 10001, then -1000 up
    to 100001, else -2000."""
    v = np.float32(0)
    for n, op in ops:
        if op == "=":
            inc = np.float32(n)
        elif op == "X":
            inc = -np.float32(n)
        elif n <= 20:
            inc = -np.float32(n)
        elif n <= 10001:
            inc = -(np.float32(3.0) * _LOG[(n - 1) // 5]) - np.float32(1.0)
        elif n <= 100001:
            inc = np.float32(-1000.0)
        else:
            inc = np.float32(-2000.0)
        v = np.float32(v + np.float32(inc))
    return float(v)


def parse(line: str) -> dict:
    f = line.split("\t")
    tags = {}
    for x in f[11:]:
        k, _t, v = x.split(":", 2)
        tags[k] = v
    return {"name": f[0], "flag": int(f[1]), "rname": f[2],
            "pos": int(f[3]), "mapq": int(f[4]), "cigar": f[5],
            "tspan": int(f[8]), "seq": f[9], "tags": tags}


def problems(rec: dict, read_codes: np.ndarray, chroms: dict) -> list:
    """What is wrong with one mapped record ([] when consistent).
    read_codes: the read as sequenced; chroms: {name: codes}."""
    out = []
    ops = [(int(n), op) for n, op in _CIGAR.findall(rec["cigar"])]
    if "".join(f"{n}{op}" for n, op in ops) != rec["cigar"] or not ops:
        return ["cigar does not parse"]
    rev = bool(rec["flag"] & 16)
    read = revcomp(read_codes) if rev else read_codes
    pre = ops[0][0] if ops[0][1] in "SH" else 0
    suf = ops[-1][0] if len(ops) > 1 and ops[-1][1] in "SH" else 0
    body = ops[1 if pre else 0:len(ops) - (1 if suf else 0)]
    if any(op in "SH" for _n, op in body):
        out.append("clip inside the alignment")
    qlen = sum(n for n, op in body if op in "=XIM")
    if pre + qlen + suf != len(read):
        out.append(f"CIGAR spans {pre + qlen + suf} read bases of "
                   f"{len(read)}")
        return out
    hard = any(op == "H" for _n, op in ops)
    want = read[pre:len(read) - suf] if hard else read
    if rec["seq"] != _ASCII[want].tobytes().decode():
        out.append("SEQ is not the read on the record's strand")
    ref = chroms.get(rec["rname"])
    if ref is None:
        return out + [f"unknown reference {rec['rname']}"]
    t = rec["pos"] - 1
    q = pre
    t0 = t
    stats = {"NX": 0, "ND": 0, "TD": 0, "NI": 0, "TI": 0}
    for n, op in body:
        if op in "=XM":
            if t + n > len(ref):
                return out + ["alignment runs past the chromosome"]
            same = read[q:q + n] == ref[t:t + n]
            if op == "=" and not same.all():
                out.append(f"'=' run at read {q} has {int((~same).sum())} "
                           "mismatches")
            if op == "X":
                if same.any():
                    out.append(f"'X' run at read {q} has matches")
                stats["NX"] += n
            q += n
            t += n
        elif op == "I":
            stats["NI"] += 1
            stats["TI"] += n
            q += n
        elif op == "D":
            stats["ND"] += 1
            stats["TD"] += n
            t += n
    if t > len(ref) or t0 < 0:
        out.append("alignment outside the chromosome")
    if rec["tspan"] != t - t0:
        out.append(f"field 9 {rec['tspan']} != reference span {t - t0}")
    tags = rec["tags"]
    stats["NM"] = stats["NX"] + stats["ND"] + stats["NI"]
    for k, v in stats.items():
        if int(tags.get(k, -1)) != v:
            out.append(f"{k} {tags.get(k)} != {v}")
    want_as = int(run_score(body))
    if int(tags.get("AS", -1)) != want_as:
        out.append(f"AS {tags.get('AS')} != {want_as}")
    return out


def placed(rec: dict, chrom_name: str, start: int, span: int,
           strand: int) -> bool:
    """The record lies on the read's source chromosome and strand and
    overlaps its source span."""
    if rec["rname"] != chrom_name or bool(rec["flag"] & 16) != bool(strand):
        return False
    t0 = rec["pos"] - 1
    return t0 < start + span and t0 + rec["tspan"] > start


def truth(rec: dict, read_len: int, start: int, span: int,
          true_as: int) -> dict:
    """How far a read's primary record falls short of the read's true
    alignment: the share of the read's bases left out of the alignment
    (%), the larger distance of the record's reference ends from the
    source span's (bases), how far its AS lies below the true
    alignment's, as a share of the span (%), and its MAPQ."""
    ops = [(int(n), op) for n, op in _CIGAR.findall(rec["cigar"])]
    aligned = sum(n for n, op in ops if op in "=XIM")
    t0 = rec["pos"] - 1
    t1 = t0 + rec["tspan"]
    return {"unaligned_pct": 100.0 * (1.0 - aligned / read_len),
            "ends_off": max(abs(t0 - start), abs(t1 - (start + span))),
            "as_short_pct": 100.0 * (true_as - int(rec["tags"].get("AS", 0)))
            / span,
            "mapq": rec["mapq"]}
