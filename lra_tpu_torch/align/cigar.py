"""Block list -> CIGAR, alignment statistics, and the concave NV score.

Vectorized equivalent of the reference's per-base string pipeline
(reference: Alignment.h:247-332 ``CreateAlignmentStrings`` +
Alignment.h:414-504 ``AlignStringsToCigar``): instead of materializing
query/align/ref strings, ops are derived directly from the block list and
2-bit code arrays.

Gap convention between adjacent blocks (Alignment.h:292-330): with
queryGap = q-jump and textGap = t-jump, the shorter is re-aligned
base-to-base ("commonGap"), emitted after an I run (query excess) and a
D run (text excess).

Scoring (NV; Alignment.h:467-504): '='-run +len, 'X'-run -len, gap run of
length L: L<=20 -> -L; L<=10001 -> -3*log(1+5*floor((L-1)/5)) - 1;
L<=100001 -> -1000; else -2000.  The reference's indel-class counters have
two quirks kept for tag parity: L==50 falls in no size class, and small
insertions are double-counted (Alignment.h:484-489).

Note: the reference swaps nins/ndel at the CalculateStatistics call site
(Alignment.h:516 passes `ndel, nins` into parameters `nins, ndel`); we use
the sane orientation (ndel = # D runs) — NM/MM tags are symmetric in them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


_LOG_TABLE = np.log(np.arange(1, 10002, 5).astype(np.float64)).astype(np.float32)


@dataclass
class AlnStats:
    cigar: str = ""
    nm: int = 0        # matched bases
    nmm: int = 0       # mismatched bases
    ndel: int = 0      # D runs
    nins: int = 0      # I runs
    tdel: int = 0      # total deleted bases
    tins: int = 0      # total inserted bases
    n_small_del: int = 0
    n_med_del: int = 0
    n_large_del: int = 0
    n_small_ins: int = 0
    n_med_ins: int = 0
    n_large_ins: int = 0
    value: float = 0.0


def _runs_eq(a: np.ndarray, b: np.ndarray):
    """Maximal runs of equality between two equal-length code arrays.
    Returns list of (is_match, length)."""
    if len(a) == 0:
        return []
    eq = a == b
    out = []
    changes = np.nonzero(np.diff(eq))[0]
    prev = 0
    for c in changes:
        out.append((bool(eq[prev]), int(c + 1 - prev)))
        prev = c + 1
    out.append((bool(eq[prev]), int(len(eq) - prev)))
    return out


_OP_CHARS = np.array(["=", "X", "I", "D"])
_OP_CHARS_M = np.array(["M", "X", "I", "D"])


def blocks_to_op_arrays(blocks, read: np.ndarray, chrom: np.ndarray,
                        show_mismatch: bool = True):
    """blocks: [(q, t, len)] ascending, q in strand frame.
    Returns (codes uint8, lens int64) merged op runs with codes
    0 = match ('='/'M'), 1 = 'X', 2 = 'I', 3 = 'D'.

    Vectorized: all aligned spans (blocks + inter-block commonGap spans,
    Alignment.h:292-330) are compared in one gather, runs found with one
    diff, and the gap/run interleave assembled by scatter."""
    nb = len(blocks)
    if nb == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    from .. import native

    nat = native.op_arrays(np.asarray(blocks, np.int64).reshape(nb, 3),
                           read, chrom, show_mismatch)
    if nat is not None:
        return nat
    q = np.fromiter((b[0] for b in blocks), np.int64, nb)
    t = np.fromiter((b[1] for b in blocks), np.int64, nb)
    ln = np.fromiter((b[2] for b in blocks), np.int64, nb)
    q_end = q + ln
    t_end = t + ln
    qgap = q[1:] - q_end[:-1]
    tgap = t[1:] - t_end[:-1]
    common = np.minimum(qgap, tgap)
    qx = qgap - common           # I-run lengths
    tx = tgap - common           # D-run lengths
    # aligned spans: blocks at even slots, commonGap re-alignments at odd
    ns = 2 * nb - 1
    span_q = np.empty(ns, np.int64)
    span_t = np.empty(ns, np.int64)
    span_l = np.empty(ns, np.int64)
    span_q[0::2] = q
    span_t[0::2] = t
    span_l[0::2] = ln
    if nb > 1:
        span_q[1::2] = q_end[:-1] + qx
        span_t[1::2] = t_end[:-1] + tx
        span_l[1::2] = np.maximum(common, 0)
    total = int(span_l.sum())
    sidx = np.repeat(np.arange(ns), span_l)
    starts = np.cumsum(span_l) - span_l
    off = np.arange(total) - starts[sidx]
    eq = np.asarray(read)[span_q[sidx] + off] == \
        np.asarray(chrom)[span_t[sidx] + off]
    if not show_mismatch:
        eq = np.ones(total, bool)
    brk = np.nonzero((eq[1:] != eq[:-1]) | (sidx[1:] != sidx[:-1]))[0] + 1
    rs = np.concatenate(([0], brk))
    rlen = np.diff(np.concatenate((rs, [total])))
    rval = eq[rs]
    rspan = sidx[rs]

    # vectorized interleave of match/mismatch runs with the I/D gap runs
    # (gaps precede each odd span), then adjacent-equal merge
    nr = len(rs)
    ngap = nb - 1
    run_pos = np.arange(nr) + 2 * ((rspan + 1) // 2)
    gi = np.arange(ngap)
    i_before = np.searchsorted(rspan, 2 * gi, side="right")
    pos_i = i_before + 2 * gi
    total_e = nr + 2 * ngap
    codes = np.empty(total_e, np.uint8)
    lens = np.empty(total_e, np.int64)
    codes[run_pos] = np.where(rval, 0, 1)        # 0 match, 1 X
    lens[run_pos] = rlen
    if ngap:
        codes[pos_i] = 2                          # I
        lens[pos_i] = qx
        codes[pos_i + 1] = 3                      # D
        lens[pos_i + 1] = tx
    keep = lens > 0
    c2, l2 = codes[keep], lens[keep]
    if len(c2) == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    newgrp = np.concatenate(([True], c2[1:] != c2[:-1]))
    gstart = np.nonzero(newgrp)[0]
    return c2[gstart], np.add.reduceat(l2, gstart)


def blocks_to_ops(blocks, read: np.ndarray, chrom: np.ndarray,
                  show_mismatch: bool = True):
    """List-of-(op_char, len) view of blocks_to_op_arrays."""
    codes, lens = blocks_to_op_arrays(blocks, read, chrom, show_mismatch)
    chars = _OP_CHARS if show_mismatch else _OP_CHARS_M
    return list(zip(chars[codes].tolist(), lens.tolist()))


_LOG_TABLE64 = _LOG_TABLE.astype(np.float64)  # native scoring reads f64;
# f64(f32 entry) matches the python path's upcast exactly


def score_op_arrays(codes: np.ndarray, lens: np.ndarray,
                    show_mismatch: bool = True) -> AlnStats:
    """Vectorized CIGAR string + stats + NV from op-run arrays."""
    from .. import native

    st = AlnStats()
    nat = native.score_ops(codes, lens, _LOG_TABLE64)
    if nat is not None:
        ic, val = nat
        (st.nm, st.nmm, st.nins, st.tins, st.ndel, st.tdel,
         st.n_small_del, st.n_med_del, st.n_large_del,
         st.n_small_ins, st.n_med_ins, st.n_large_ins) = \
            (int(x) for x in ic)
        st.value = val
        nc = native.cigar_string(codes, lens,
                                 "=XID" if show_mismatch else "MXID")
        if nc is not None:
            st.cigar = nc
            return st
        chars = _OP_CHARS if show_mismatch else _OP_CHARS_M
        cl = chars[codes]
        st.cigar = "".join(
            f"{int(ln)}{c}" for c, ln in zip(cl.tolist(), lens.tolist()))
        return st
    is_m = codes == 0
    is_x = codes == 1
    is_i = codes == 2
    is_d = codes == 3
    st.nm = int(lens[is_m].sum())
    st.nmm = int(lens[is_x].sum())
    D = lens[is_d]
    I = lens[is_i]
    st.ndel = len(D)
    st.tdel = int(D.sum())
    st.nins = len(I)
    st.tins = int(I.sum())
    st.n_small_del = int((D <= 10).sum())
    st.n_med_del = int(((D > 10) & (D < 50)).sum())
    st.n_large_del = int((D > 50).sum())
    st.n_small_ins = int((I <= 10).sum()) + int((I <= 20).sum())
    st.n_med_ins = int(((I > 10) & (I < 50)).sum())
    st.n_large_ins = int((I > 50).sum())
    # the reference accumulates `value` in FLOAT, one increment per run
    # in run order (Alignment.h:54,414-504) — at megabase NV scale f64
    # sums diverge from its rounding, so build per-run f32 increments
    # and f32-cumsum them (sequential adds, same grouping)
    l32 = lens.astype(np.float32)
    idx = np.clip((lens - 1) // 5, 0, len(_LOG_TABLE) - 1)
    gap32 = np.where(
        lens <= 20, -l32,
        np.where(lens <= 10001,
                 (-(np.float32(3.0) * _LOG_TABLE[idx])
                  - np.float32(1.0)).astype(np.float32),
                 np.where(lens <= 100001, np.float32(-1000.0),
                          np.float32(-2000.0)))).astype(np.float32)
    incr = np.where(is_m, l32, np.where(is_x, -l32, gap32))
    st.value = float(np.cumsum(incr, dtype=np.float32)[-1]) if len(incr) \
        else 0.0
    from .. import native

    nc = native.cigar_string(codes, lens,
                             "=XID" if show_mismatch else "MXID")
    if nc is not None:
        st.cigar = nc
    else:
        chars = _OP_CHARS if show_mismatch else _OP_CHARS_M
        cl = chars[codes]
        st.cigar = "".join(f"{n}{c}" for n, c in zip(lens.tolist(),
                                                     cl.tolist()))
    return st


def score_ops(ops, read=None, chrom=None, blocks=None) -> AlnStats:
    """CIGAR string + stats + NV from an op run list (f32 accumulation
    in run order — the reference's `float value`, Alignment.h:54)."""
    st = AlnStats()
    parts = []
    val = np.float32(0.0)
    for op, ln in ops:
        parts.append(f"{ln}{op}")
        if op == "=":
            st.nm += ln
            val += ln
        elif op == "X":
            st.nmm += ln
            val -= ln
        elif op == "M":
            st.nm += ln   # show_mismatch=False path: refined by caller
            val += ln
        elif op == "D":
            st.tdel += ln
            st.ndel += 1
            if ln <= 10:
                st.n_small_del += 1
            if 10 < ln < 50:
                st.n_med_del += 1
            elif ln > 50:
                st.n_large_del += 1
            val += _gap_value(ln)
        elif op == "I":
            st.tins += ln
            st.nins += 1
            if ln <= 10:
                st.n_small_ins += 1
            if 10 < ln < 50:
                st.n_med_ins += 1
            elif ln > 50:
                st.n_large_ins += 1
            if ln <= 20:
                st.n_small_ins += 1  # reference double-count quirk
            val += _gap_value(ln)
    st.value = float(val)
    st.cigar = "".join(parts)
    return st


_BASES = "ACGTN"


def ops_to_md(ops, read: np.ndarray, chrom: np.ndarray, q0: int,
              t0: int) -> str:
    """MD:Z tag from an op run list (reference: AlignmentStringsToMD,
    Alignment.h:204-244): run-length of matches, mismatched ref base,
    '^'+bases for deletions; insertions don't appear."""
    md: list = []
    match = 0
    q, t = int(q0), int(t0)
    for op, ln in ops:
        if op in ("=", "M"):
            if op == "M":
                # 'M' may hide mismatches; split by actual equality
                off = 0
                for is_m, rl in _runs_eq(read[q:q + ln], chrom[t:t + ln]):
                    if is_m:
                        match += rl
                    else:
                        for i in range(rl):
                            md.append(str(match))
                            match = 0
                            md.append(_BASES[int(chrom[t + off + i])])
                    off += rl
            else:
                match += ln
            q += ln
            t += ln
        elif op == "X":
            for i in range(ln):
                md.append(str(match))
                match = 0
                md.append(_BASES[int(chrom[t + i])])
            q += ln
            t += ln
        elif op == "I":
            q += ln
        elif op == "D":
            md.append(str(match))
            match = 0
            md.append("^" + "".join(_BASES[int(c)] for c in chrom[t:t + ln]))
            t += ln
    md.append(str(match))
    return "".join(md)


def _gap_value(ln: int):
    """f32 gap increment, exactly as the reference computes it
    (Alignment.h:469: -3.0f*LookUpTable[a] - 1 in float)."""
    if ln <= 20:
        return np.float32(-ln)
    if ln <= 10001:
        return -(np.float32(3.0) * _LOG_TABLE[(ln - 1) // 5]) \
            - np.float32(1.0)
    if ln <= 100001:
        return np.float32(-1000.0)
    return np.float32(-2000.0)
