"""Faults planted in the window's SAM lines, where the answers are
produced: the CPU tests plant them under a whole run, and
``readings.py`` reads what each does to the numbers of the output check
at a cell's own size (the upper readings of their limits)."""

from __future__ import annotations

from bench_port.reference import sam


def truncate(line: str) -> str:
    """A mapped record cut to the first half of its aligned read bases,
    the rest soft-clipped (hard-clipped where the record hard-clips),
    with its field 9, SEQ and tags made consistent again: an alignment
    that is valid, placed, and short."""
    f = line.split("\t")
    if int(f[1]) & 4:
        return line
    ops = [(int(n), op) for n, op in sam._CIGAR.findall(f[5])]
    pre = [ops.pop(0)] if ops[0][1] in "SH" else []
    suf = [ops.pop()] if ops and ops[-1][1] in "SH" else []
    clip = "H" if any(op == "H" for _n, op in pre + suf) else "S"
    want = sum(n for n, op in ops if op in "=XIM") // 2
    body, got = [], 0
    for n, op in ops:
        if got >= want:
            break
        if op in "=XIM":
            n = min(n, want - got)
            got += n
        body.append((n, op))
    while body and body[-1][1] == "D":
        body.pop()
    cut = sum(n for n, op in ops if op in "=XIM") - got
    if clip == "H":
        f[9] = f[9][:len(f[9]) - cut] if cut else f[9]
    tail = cut + (suf[0][0] if suf else 0)
    new = pre + body + ([(tail, clip)] if tail else [])
    f[5] = "".join(f"{n}{op}" for n, op in new)
    stats = {"NX": 0, "ND": 0, "TD": 0, "NI": 0, "TI": 0}
    tspan = 0
    for n, op in body:
        if op in "=XM":
            tspan += n
            stats["NX"] += n if op == "X" else 0
        elif op == "D":
            tspan += n
            stats["ND"] += 1
            stats["TD"] += n
        elif op == "I":
            stats["NI"] += 1
            stats["TI"] += n
    stats["NM"] = stats["NX"] + stats["ND"] + stats["NI"]
    value = sam.run_score(body)
    stats["AS"] = int(value)
    f[8] = str(tspan)
    for k, x in enumerate(f[11:], 11):
        tag = x.split(":", 1)[0]
        if tag in stats:
            f[k] = f"{tag}:i:{stats[tag]}"
        elif tag == "NV":
            f[k] = f"NV:f:{value:g}"
    return "\t".join(f)


def mapq_zero(line: str) -> str:
    """A mapped record whose MAPQ says it could lie anywhere."""
    f = line.split("\t")
    if not int(f[1]) & 4:
        f[4] = "0"
    return "\t".join(f)


FAULTS = {"truncate": truncate, "mapq_zero": mapq_zero}


def plant(name: str, window) -> None:
    """Plant fault ``name`` in every line of the window."""
    fn = FAULTS[name]
    window.lines = [[fn(ln) for ln in lines]
                    for lines in window.lines]

