"""Block list -> CIGAR, alignment statistics, and the concave NV score.

Equivalent of the reference's per-base string pipeline (reference:
Alignment.h:247-332 ``CreateAlignmentStrings`` + Alignment.h:414-504
``AlignStringsToCigar``): instead of materializing query/align/ref
strings, ops are derived directly from the block list and 2-bit code
arrays, in the native host library.

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

from .. import native

# the reference's f32 LookUpTable, held in f64 for the native scorer
# (f64 of an f32 entry is that entry exactly)
_LOG_TABLE64 = np.log(np.arange(1, 10002, 5).astype(np.float64)) \
    .astype(np.float32).astype(np.float64)


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
    0 = match ('='/'M'), 1 = 'X', 2 = 'I', 3 = 'D' (native.op_arrays:
    blocks and inter-block commonGap spans, Alignment.h:292-330)."""
    nb = len(blocks)
    if nb == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    return native.op_arrays(np.asarray(blocks, np.int64).reshape(nb, 3),
                            read, chrom, show_mismatch)


def blocks_to_ops(blocks, read: np.ndarray, chrom: np.ndarray,
                  show_mismatch: bool = True):
    """List-of-(op_char, len) view of blocks_to_op_arrays."""
    codes, lens = blocks_to_op_arrays(blocks, read, chrom, show_mismatch)
    chars = _OP_CHARS if show_mismatch else _OP_CHARS_M
    return list(zip(chars[codes].tolist(), lens.tolist()))


def score_op_arrays(codes: np.ndarray, lens: np.ndarray,
                    show_mismatch: bool = True) -> AlnStats:
    """CIGAR string + stats + NV from op-run arrays, both in the native
    library (NV accumulated in f32, one increment per run in run order:
    the reference's `float value`, Alignment.h:54,414-504)."""
    st = AlnStats()
    ic, st.value = native.score_ops(codes, lens, _LOG_TABLE64)
    (st.nm, st.nmm, st.nins, st.tins, st.ndel, st.tdel,
     st.n_small_del, st.n_med_del, st.n_large_del,
     st.n_small_ins, st.n_med_ins, st.n_large_ins) = (int(x) for x in ic)
    st.cigar = native.cigar_string(codes, lens,
                                   "=XID" if show_mismatch else "MXID")
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
