"""ctypes bindings for the native runtime library.

Auto-builds liblra_native.so into the package's build directory
(lra_tpu_torch/_build/) on first use if a compiler is available;
every entry point has a pure-Python fallback, so the package works
without the native layer (``available()`` reports which path is live).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(__file__)
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(_BUILD, "liblra_native.so")
_lib = None
_load_lock = threading.Lock()

# Bumped whenever an existing exported C signature changes; _bind refuses
# a .so reporting a different version (a stale prebuilt library with no
# working compiler would otherwise be called through mismatched argtypes).
_ABI_VERSION = 5


def _try_build() -> None:
    try:
        os.makedirs(_BUILD, exist_ok=True)
        subprocess.run(["make", "-C", _DIR, "-s", f"OUT={_SO}"], check=True,
                       capture_output=True, timeout=120)
    except Exception:
        pass


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # serialize first-touch: concurrent pool threads (threaded index
    # build, stream workers) must not race a parallel `make` on the same
    # .so or CDLL a partially written library
    with _load_lock:
        if _lib is not None:
            return _lib
        # always invoke make: a no-op when fresh, a rebuild when the
        # source is newer than a stale .so
        _try_build()
        if not os.path.exists(_SO):
            _lib = False
            return _lib
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _lib = False
            return _lib
        try:
            return _bind(lib)
        except AttributeError:
            # stale prebuilt .so missing newer symbols and no working
            # compiler to rebuild: honor the pure-python fallback contract
            _lib = False
            return _lib


def _bind(lib):
    global _lib
    lib.lrn_abi_version.restype = ctypes.c_int
    lib.lrn_abi_version.argtypes = []
    if lib.lrn_abi_version() != _ABI_VERSION:
        _lib = False
        return _lib
    lib.lrn_load_seqs.restype = ctypes.c_int
    lib.lrn_load_seqs.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.lrn_minimizers.restype = ctypes.c_int64
    lib.lrn_minimizers.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.lrn_minimizers_ref.restype = ctypes.c_int64
    lib.lrn_minimizers_ref.argtypes = lib.lrn_minimizers.argtypes
    lib.lrn_linear_extend.restype = ctypes.c_int64
    lib.lrn_linear_extend.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.lrn_counting_argsort_i32.restype = ctypes.c_int
    lib.lrn_counting_argsort_i32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p]
    lib.lrn_local_index_build.restype = ctypes.c_int64
    lib.lrn_local_index_build.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.lrn_match_batch.restype = ctypes.c_int64
    lib.lrn_match_batch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int64]
        + [ctypes.c_void_p, ctypes.c_int64]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
        + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        + [ctypes.c_void_p] * 5 + [ctypes.c_int64]
    )
    lib.lrn_match_lut_build.restype = None
    lib.lrn_match_lut_build.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64]
    lib.lrn_local_reseed.restype = ctypes.c_int64
    lib.lrn_local_reseed.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4
        + [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int]
        + [ctypes.c_int64] * 6
        + [ctypes.c_void_p] * 2 + [ctypes.c_int64]
    )
    lib.lrn_banded_align.restype = ctypes.c_int32
    lib.lrn_banded_align.argtypes = (
        [ctypes.c_void_p, ctypes.c_int32] * 2
        + [ctypes.c_int32] * 5
        + [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
    )
    lib.lrn_cigar_string.restype = ctypes.c_int64
    lib.lrn_cigar_string.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
    lib.lrn_blocks_packed.restype = ctypes.c_int64
    lib.lrn_blocks_packed.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.lrn_score_ops.restype = None
    lib.lrn_score_ops.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.lrn_op_arrays.restype = ctypes.c_int64
    lib.lrn_op_arrays.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.lrn_plan_indel_regions.restype = ctypes.c_int64
    lib.lrn_plan_indel_regions.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64]
    lib.lrn_refine_dp_shaped.restype = ctypes.c_int64
    lib.lrn_refine_dp_shaped.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.lrn_refine_dp.restype = ctypes.c_int64
    lib.lrn_refine_dp.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    _lib = lib
    return _lib


def available() -> bool:
    return bool(_load())


def cigar_string(codes: np.ndarray, lens: np.ndarray,
                 op_chars: str):
    """CIGAR text from op-run arrays; None if unavailable."""
    lib = _load()
    if not lib:
        return None
    n = len(codes)
    buf = ctypes.create_string_buffer(24 * max(1, n))
    ln = lib.lrn_cigar_string(
        np.ascontiguousarray(codes, np.uint8)
        .ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(lens, np.int64)
        .ctypes.data_as(ctypes.c_void_p),
        n, op_chars.encode(), buf, len(buf))
    if ln < 0:
        return None
    return buf.raw[:ln].decode()


_SCRATCH = threading.local()


def _scratch_i32(n: int) -> np.ndarray:
    """Reusable per-thread int32 scratch (decode output buffers are
    written then immediately consumed, so one growing buffer avoids
    re-allocating tens of MB per bucket; thread-local because
    pipeline.stream workers decode concurrently)."""
    buf = getattr(_SCRATCH, "i32", None)
    if buf is None or buf.size < n:
        buf = np.empty(n, np.int32)
        _SCRATCH.i32 = buf
    return buf


def blocks_from_packed_arrays(packed: np.ndarray):
    """blocks_from_packed without the python-list materialization:
    returns (flat int32[total, 3] COPY, counts int32[B]) — job b's
    blocks are flat[offs[b]:offs[b]+counts[b]] with offs = cumsum
    exclusive — or None if the native library is unavailable.  The
    gap-align round lays them into its table's CSR of solved blocks
    (pipeline/gap_align.solve_gap_jobs) as they come."""
    lib = _load()
    if not lib:
        return None
    packed = np.ascontiguousarray(packed, np.uint8)
    B, L4 = packed.shape
    counts = np.empty(B, np.int32)
    hard_cap = B * (2 * L4 + 1)
    cap = min(96, 2 * L4 + 1) * B + 1024
    total = -1
    while total < 0:
        out = _scratch_i32(cap * 3)
        total = lib.lrn_blocks_packed(
            packed.ctypes.data_as(ctypes.c_void_p), B, L4,
            out.ctypes.data_as(ctypes.c_void_p), cap,
            counts.ctypes.data_as(ctypes.c_void_p))
        if total < 0:
            if cap >= hard_cap:
                return None
            cap = min(cap * 8, hard_cap)
    # copy out of the shared scratch: the next bucket's decode reuses it
    return out[:total * 3].reshape(-1, 3).copy(), counts


def blocks_from_packed(packed: np.ndarray):
    """Decode a [B, L4] bucket of 2-bit packed device-traceback planes
    into B block lists in one C pass (identical output to
    affine_kernel.blocks_from_ops_batch(unpack_ops(plane, False))).
    Returns a list of B lists of [q_off, t_off, len], or None if the
    native library is unavailable."""
    lib = _load()
    if not lib:
        return None
    packed = np.ascontiguousarray(packed, np.uint8)
    B, L4 = packed.shape
    # worst case a row of L = 4*L4 ops has ceil(L/2)+1 DIAG runs, but
    # real planes average ~10-60 blocks/row; allocating the worst case
    # (tens of MB per bucket) dominated the call, so start small and
    # retry on overflow
    counts = np.empty(B, np.int32)
    hard_cap = B * (2 * L4 + 1)
    cap = min(96, 2 * L4 + 1) * B + 1024
    total = -1
    while total < 0:
        out = _scratch_i32(cap * 3)
        total = lib.lrn_blocks_packed(
            packed.ctypes.data_as(ctypes.c_void_p), B, L4,
            out.ctypes.data_as(ctypes.c_void_p), cap,
            counts.ctypes.data_as(ctypes.c_void_p))
        if total < 0:
            if cap >= hard_cap:
                return None
            cap = min(cap * 8, hard_cap)
    tr = out[:total * 3].reshape(-1, 3).tolist()
    res = []
    off = 0
    for c in counts.tolist():
        res.append(tr[off:off + c])
        off += c
    return res


def score_ops(codes: np.ndarray, lens: np.ndarray, logtab: np.ndarray):
    """Native stats + NV value over op-run arrays.  Returns
    (icounts int64[12], value float) or None.

    The value accumulates sequentially in op order (the reference's own
    walk, Alignment.h:467-504); the numpy fallback uses pairwise
    summation, so the two can differ by ~1e-9 relative — far inside the
    golden-suite NV tolerance and the :g output formatting."""
    lib = _load()
    if not lib:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    lens = np.ascontiguousarray(lens, np.int64)
    ic = np.zeros(12, np.int64)
    val = ctypes.c_double()
    lib.lrn_score_ops(
        codes.ctypes.data_as(ctypes.c_void_p),
        lens.ctypes.data_as(ctypes.c_void_p), len(codes),
        logtab.ctypes.data_as(ctypes.c_void_p), len(logtab),
        ic.ctypes.data_as(ctypes.c_void_p), ctypes.byref(val))
    return ic, val.value


def op_arrays(blocks: np.ndarray, read: np.ndarray, chrom: np.ndarray,
              show_mismatch: bool):
    """Native mirror of align/cigar.blocks_to_op_arrays.  blocks: [n,3]
    int64 ascending.  Returns (codes uint8, lens int64) or None."""
    lib = _load()
    if not lib:
        return None
    blocks = np.ascontiguousarray(blocks, np.int64)
    read = np.ascontiguousarray(read, np.uint8)
    chrom = np.ascontiguousarray(chrom, np.uint8)
    nb = len(blocks)
    if nb == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    # every run is >= 1 base of q or t extent, plus 2 gap runs per join
    qext = int(blocks[-1, 0] + blocks[-1, 2] - blocks[0, 0])
    text = int(blocks[-1, 1] + blocks[-1, 2] - blocks[0, 1])
    cap = qext + text + 2 * nb + 4
    codes = np.empty(cap, np.uint8)
    lens = np.empty(cap, np.int64)
    n = lib.lrn_op_arrays(
        blocks.ctypes.data_as(ctypes.c_void_p), nb,
        read.ctypes.data_as(ctypes.c_void_p),
        chrom.ctypes.data_as(ctypes.c_void_p),
        1 if show_mismatch else 0,
        codes.ctypes.data_as(ctypes.c_void_p),
        lens.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        return None
    return codes[:n].copy(), lens[:n].copy()


def plan_indel_regions(blocks: np.ndarray, read: np.ndarray,
                       chrom: np.ndarray, max_gap: int, span_cap: int,
                       diag_ok: bool, refine_band: int):
    """Native indel-refine region planner + trivial-region classifier
    (mirror of align/indel_refine.plan_refine_regions + the fast-path
    logic of queue_indel_refine_jobs).  blocks: [n,3] int64 ascending.
    Returns int64 [nreg, 10] rows (lo, hi, trim0, keep1, q0, t0, q1, t1,
    band, kind) — kind 0 = identity skip, 1 = refine job, 2 = tiny
    linear job — or None if the native library is unavailable."""
    lib = _load()
    if not lib:
        return None
    blocks = np.ascontiguousarray(blocks, np.int64)
    read = np.ascontiguousarray(read, np.uint8)
    chrom = np.ascontiguousarray(chrom, np.uint8)
    n = len(blocks)
    cap = n + 1
    out = np.empty((cap, 10), np.int64)
    nreg = lib.lrn_plan_indel_regions(
        blocks.ctypes.data_as(ctypes.c_void_p), n,
        read.ctypes.data_as(ctypes.c_void_p),
        chrom.ctypes.data_as(ctypes.c_void_p),
        max_gap, span_cap, 1 if diag_ok else 0, refine_band,
        out.ctypes.data_as(ctypes.c_void_p), cap)
    if nreg < 0:
        return None
    return out[:nreg]


def banded_align(q: np.ndarray, t: np.ndarray, K: int, kband: int,
                 m: int, mm: int, indel: int):
    """Native banded-global alignment of one problem (scalar mirror of
    ops/affine_kernel.banded_global_np + traceback_banded — identical
    blocks).  Returns (blocks list, score) or None if unavailable."""
    lib = _load()
    if not lib:
        return None
    q = np.ascontiguousarray(q, np.int8)
    t = np.ascontiguousarray(t, np.int8)
    max_blocks = len(q) + len(t) + 2
    out = np.empty(max_blocks * 3, np.int32)
    score = ctypes.c_int32()
    nb = lib.lrn_banded_align(
        q.ctypes.data_as(ctypes.c_void_p), len(q),
        t.ctypes.data_as(ctypes.c_void_p), len(t),
        K, kband, m, mm, indel,
        out.ctypes.data_as(ctypes.c_void_p), max_blocks,
        ctypes.byref(score))
    if nb < 0:
        return None
    tr = out[:nb * 3].reshape(-1, 3)
    return ([(int(a), int(b), int(c)) for a, b, c in tr],
            int(score.value))


def load_seqs(path: str, want_quals: bool = False):
    """Native FASTA/FASTQ(.gz) loader.

    Returns (names, offsets int64[n+1], codes uint8, quals|None) or None
    if the native library is unavailable.
    """
    lib = _load()
    if not lib:
        return None
    tl = ctypes.c_int64()
    ns = ctypes.c_int64()
    nl = ctypes.c_int64()
    rc = lib.lrn_load_seqs(path.encode(), None, 0, None, 0, None, 0, None,
                           ctypes.byref(tl), ctypes.byref(ns),
                           ctypes.byref(nl))
    if rc != 0:
        raise IOError(f"lrn_load_seqs({path}) failed: {rc}")
    codes = np.empty(tl.value, np.uint8)
    offsets = np.empty(ns.value + 1, np.int64)
    names_buf = ctypes.create_string_buffer(max(1, nl.value))
    quals = np.empty(tl.value, np.uint8) if want_quals else None
    rc = lib.lrn_load_seqs(
        path.encode(),
        codes.ctypes.data_as(ctypes.c_void_p), codes.size,
        offsets.ctypes.data_as(ctypes.c_void_p), offsets.size,
        names_buf, nl.value,
        quals.ctypes.data_as(ctypes.c_void_p) if want_quals else None,
        ctypes.byref(tl), ctypes.byref(ns), ctypes.byref(nl))
    if rc != 0:
        raise IOError(f"lrn_load_seqs({path}) fill failed: {rc}")
    names = names_buf.raw[:nl.value].decode().split("\n")[:-1]
    return names, offsets, codes, quals


def minimizers(codes: np.ndarray, k: int, w: int, canonical: bool = True,
               exact: bool = True):
    """Native minimizer extraction; None if unavailable.  exact=True uses
    the reference's streaming emission semantics (lrn_minimizers_ref),
    exact=False the leftmost-tie-break windowed-minimum rule."""
    lib = _load()
    if not lib:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    cap = max(16, len(codes))
    tup = np.empty(cap, np.uint64)
    pos = np.empty(cap, np.uint32)
    strand = np.empty(cap, np.uint8)
    fn = lib.lrn_minimizers_ref if exact else lib.lrn_minimizers
    n = fn(
        codes.ctypes.data_as(ctypes.c_void_p), len(codes), k, w,
        1 if canonical else 0,
        tup.ctypes.data_as(ctypes.c_void_p),
        pos.ctypes.data_as(ctypes.c_void_p),
        strand.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        raise RuntimeError("lrn_minimizers capacity exceeded")
    return tup[:n].copy(), pos[:n].copy(), strand[:n].copy()


def linear_extend(read: np.ndarray, chrom: np.ndarray, q: np.ndarray,
                  t: np.ndarray, strand: int, K: int, pts):
    """Native linear anchor extension walk; None if unavailable.

    q/t: diagonal-sorted int64 anchor starts; pts: [(coord, is_t)].
    Returns (out_q, out_t, out_len, out_ovp)."""
    lib = _load()
    if not lib:
        return None
    n = len(q)
    read = np.ascontiguousarray(read, np.uint8)
    chrom = np.ascontiguousarray(chrom, np.uint8)
    q = np.ascontiguousarray(q, np.int64)
    t = np.ascontiguousarray(t, np.int64)
    npts = len(pts)
    pc = np.fromiter((p[0] for p in pts), np.int64, npts) if npts else \
        np.zeros(0, np.int64)
    pt = np.fromiter((1 if p[1] else 0 for p in pts), np.uint8, npts) \
        if npts else np.zeros(0, np.uint8)
    cap = 2 * n + 2
    oq = np.empty(cap, np.int64)
    ot = np.empty(cap, np.int64)
    ol = np.empty(cap, np.int64)
    ov = np.empty(cap, np.uint8)
    cnt = lib.lrn_linear_extend(
        read.ctypes.data_as(ctypes.c_void_p), len(read),
        chrom.ctypes.data_as(ctypes.c_void_p), len(chrom),
        q.ctypes.data_as(ctypes.c_void_p),
        t.ctypes.data_as(ctypes.c_void_p), n, strand, K,
        pc.ctypes.data_as(ctypes.c_void_p),
        pt.ctypes.data_as(ctypes.c_void_p), npts,
        oq.ctypes.data_as(ctypes.c_void_p),
        ot.ctypes.data_as(ctypes.c_void_p),
        ol.ctypes.data_as(ctypes.c_void_p),
        ov.ctypes.data_as(ctypes.c_void_p))
    return (oq[:cnt].copy(), ot[:cnt].copy(), ol[:cnt].copy(),
            ov[:cnt].astype(bool))


def local_index_build(codes: np.ndarray, k: int, w: int, window: int,
                      max_freq: int, exact: bool = True):
    """Native per-window local index build; None if unavailable.
    Returns (tuples u64, pos u32, tuple_bounds i64[nwin+1])."""
    lib = _load()
    if not lib:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    n = len(codes)
    nwin = (n + window - 1) // window
    cap = max(16, n + 16)
    tup = np.empty(cap, np.uint64)
    pos = np.empty(cap, np.uint32)
    bounds = np.empty(nwin + 1, np.int64)
    total = lib.lrn_local_index_build(
        codes.ctypes.data_as(ctypes.c_void_p), n, k, w, window, max_freq,
        1 if exact else 0,
        tup.ctypes.data_as(ctypes.c_void_p),
        pos.ctypes.data_as(ctypes.c_void_p),
        bounds.ctypes.data_as(ctypes.c_void_p), cap)
    if total < 0:
        raise RuntimeError("lrn_local_index_build capacity exceeded")
    return tup[:total].copy(), pos[:total].copy(), bounds


def local_reseed(genome_li, rli, ls: int, le: int, chrom_off: int,
                 read_len: int, max_freq: int, margin: int,
                 t_sorted: np.ndarray, q_by_t: np.ndarray,
                 qend_by_t: np.ndarray, lowacc_walk: bool,
                 min_dn: int, max_dn: int, qlo: int, qhi: int,
                 tlo: int, thi: int):
    """Native per-cluster local-index reseeding walk; None if unavailable.
    lowacc_walk selects the Refine_splitchain per-window read range
    (strict window bounds, min qStart / max qEnd over the range) vs the
    REFINEclusters endpoint rule.  Returns (qpos i64, tpos i64)."""
    lib = _load()
    if not lib:
        return None
    t_sorted = np.ascontiguousarray(t_sorted, np.int64)
    q_by_t = np.ascontiguousarray(q_by_t, np.int64)
    qend_by_t = np.ascontiguousarray(qend_by_t, np.int64)
    cap = 1 << 14
    while True:
        oq = np.empty(cap, np.int64)
        ot = np.empty(cap, np.int64)
        cnt = lib.lrn_local_reseed(
            genome_li.tuples.ctypes.data_as(ctypes.c_void_p),
            genome_li.pos.ctypes.data_as(ctypes.c_void_p),
            genome_li.seq_offsets.ctypes.data_as(ctypes.c_void_p),
            genome_li.tuple_bounds.ctypes.data_as(ctypes.c_void_p),
            ls, le, chrom_off,
            rli.tuples.ctypes.data_as(ctypes.c_void_p),
            rli.pos.ctypes.data_as(ctypes.c_void_p),
            rli.seq_offsets.ctypes.data_as(ctypes.c_void_p),
            rli.tuple_bounds.ctypes.data_as(ctypes.c_void_p),
            rli.nwindows(),
            read_len, max_freq, margin,
            t_sorted.ctypes.data_as(ctypes.c_void_p),
            q_by_t.ctypes.data_as(ctypes.c_void_p),
            qend_by_t.ctypes.data_as(ctypes.c_void_p), len(t_sorted),
            1 if lowacc_walk else 0,
            min_dn, max_dn, qlo, qhi, tlo, thi,
            oq.ctypes.data_as(ctypes.c_void_p),
            ot.ctypes.data_as(ctypes.c_void_p), cap)
        if cnt >= 0:
            return oq[:cnt].copy(), ot[:cnt].copy()
        cap *= 4


_LUT_BITS = 22           # 4M buckets (32MB) — built once per index
_LUT_MIN_NI = 1 << 20    # below ~1M index rows plain binary search wins


def match_lut_build(it: np.ndarray, tuple_bits: int):
    """Prefix LUT over a sorted tuple index for large genomes; returns
    (lut int64[nb+1], shift, nb) or None (unavailable / index small)."""
    lib = _load()
    if not lib or len(it) < _LUT_MIN_NI:
        return None
    it = np.ascontiguousarray(it, np.uint64)
    bits = min(_LUT_BITS, tuple_bits)
    shift = max(0, tuple_bits - bits)
    nb = 1 << bits
    lut = np.empty(nb + 1, np.int64)
    lib.lrn_match_lut_build(
        it.ctypes.data_as(ctypes.c_void_p), len(it), shift,
        lut.ctypes.data_as(ctypes.c_void_p), nb)
    return lut, shift, nb


def match_batch(qt, qp, qs, read_off, it, ip, istr, ifr, max_freq,
                lut=None):
    """Native batched anchor intersection (CompareLists analog).

    qt/qp/qs: concatenated per-read minimizer tuples/positions/strands;
    read_off: int64[n_reads+1] read boundaries; it/ip/istr/ifr: the
    sorted global index arrays.  Returns (qpos, tpos, freq, is_rev,
    read_start) matching anchors.find_matches_batch's numpy path
    bit-for-bit, or None if the native library is unavailable."""
    lib = _load()
    if not lib:
        return None
    qt = np.ascontiguousarray(qt, np.uint64)
    qp = np.ascontiguousarray(qp, np.uint32)
    qs = np.ascontiguousarray(qs, np.uint8)
    read_off = np.ascontiguousarray(read_off, np.int64)
    # no-ops when the index is already in its native layout
    it = np.ascontiguousarray(it, np.uint64)
    ip = np.ascontiguousarray(ip, np.uint32)
    istr = np.ascontiguousarray(istr, np.uint8)
    ifr = np.ascontiguousarray(ifr, np.int32)
    n_reads = len(read_off) - 1
    cap = max(1024, 4 * len(qt))
    for _ in range(2):
        qpos = np.empty(cap, np.int64)
        tpos = np.empty(cap, np.int64)
        freq = np.empty(cap, np.int64)
        rev = np.empty(cap, np.uint8)
        rstart = np.empty(n_reads + 1, np.int64)
        if lut is not None:
            lut_arr, lut_shift, lut_nb = lut
            lut_ptr = lut_arr.ctypes.data_as(ctypes.c_void_p)
        else:
            lut_ptr, lut_shift, lut_nb = None, 0, 0
        n = lib.lrn_match_batch(
            qt.ctypes.data_as(ctypes.c_void_p),
            qp.ctypes.data_as(ctypes.c_void_p),
            qs.ctypes.data_as(ctypes.c_void_p), len(qt),
            read_off.ctypes.data_as(ctypes.c_void_p), n_reads,
            it.ctypes.data_as(ctypes.c_void_p),
            ip.ctypes.data_as(ctypes.c_void_p),
            istr.ctypes.data_as(ctypes.c_void_p),
            ifr.ctypes.data_as(ctypes.c_void_p), len(it), max_freq,
            lut_ptr, lut_shift, lut_nb,
            qpos.ctypes.data_as(ctypes.c_void_p),
            tpos.ctypes.data_as(ctypes.c_void_p),
            freq.ctypes.data_as(ctypes.c_void_p),
            rev.ctypes.data_as(ctypes.c_void_p),
            rstart.ctypes.data_as(ctypes.c_void_p), cap)
        if n >= 0:
            return (qpos[:n], tpos[:n], freq[:n], rev[:n].astype(bool),
                    rstart)
        cap = -n
    return None


def counting_argsort_i32(keys: np.ndarray, max_range: int = 1 << 20):
    """Stable counting argsort for small-range int32 keys; None if the
    native lib is unavailable or the range is too wide."""
    lib = _load()
    if not lib:
        return None
    keys = np.ascontiguousarray(keys, np.int32)
    out = np.empty(len(keys), np.int64)
    rc = lib.lrn_counting_argsort_i32(
        keys.ctypes.data_as(ctypes.c_void_p), len(keys), max_range,
        out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        return None
    return out


def refine_dp(q: np.ndarray, t: np.ndarray, K: int, kband: int,
              m: int, mm: int, indel: int):
    """Refine-lane banded DP + traceback for one long indel-refine
    region (C mirror of ops/affine_kernel.banded_refine_np +
    traceback_refine, identical recurrence/tie order).  Returns blocks
    as an int64 [n, 3] array of (q_off, t_off, len), or None if the
    native lib is unavailable."""
    lib = _load()
    if not lib:
        return None
    q = np.ascontiguousarray(q, np.int8)
    t = np.ascontiguousarray(t, np.int8)
    cap = len(q) + len(t) + 2
    out = np.empty((cap, 3), np.int64)
    nb = lib.lrn_refine_dp(
        q.ctypes.data_as(ctypes.c_void_p), len(q),
        t.ctypes.data_as(ctypes.c_void_p), len(t),
        K, kband, m, mm, indel,
        out.ctypes.data_as(ctypes.c_void_p), cap)
    if nb < 0:
        return None
    return out[:nb].copy()


def refine_dp_shaped(q: np.ndarray, t: np.ndarray, path: np.ndarray,
                     k: int, m: int, mm: int, indel: int):
    """Shaped-band refine DP: per-row q windows dilated from the
    region's existing block path (the reference's qS/qE geometry,
    IndelRefine.h:219-330, as a slightly wider superset).  path:
    [n,3] int64 job-local (q,t,len) triples spanning (0,0)..(qlen,tlen).
    Returns blocks as an int64 [n, 3] array of (q_off, t_off, len), or
    None if unavailable."""
    lib = _load()
    if not lib:
        return None
    q = np.ascontiguousarray(q, np.int8)
    t = np.ascontiguousarray(t, np.int8)
    path = np.ascontiguousarray(path, np.int64)
    cap = len(q) + len(t) + 2
    out = np.empty((cap, 3), np.int64)
    nb = lib.lrn_refine_dp_shaped(
        q.ctypes.data_as(ctypes.c_void_p), len(q),
        t.ctypes.data_as(ctypes.c_void_p), len(t),
        path.ctypes.data_as(ctypes.c_void_p), len(path),
        k, m, mm, indel,
        out.ctypes.data_as(ctypes.c_void_p), cap)
    if nb < 0:
        return None
    return out[:nb].copy()
