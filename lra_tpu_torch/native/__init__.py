"""ctypes bindings for the port's native host library.

``lra_native.cpp`` builds with ``make`` (g++) into
``lra_tpu_torch/_build/liblra_native.so``.  The first call of a process
runs make, which rebuilds the library when the source is newer and does
nothing otherwise, then loads it.  A failed or timed-out build raises
``RuntimeError`` with the compiler's output, and no library a failed
rebuild left behind is ever loaded; a library that cannot be loaded,
lacks a symbol or reports another ABI version raises too.  Nothing here
falls back to Python, as nothing in ops/_ext.py falls back from a CUDA
kernel: the port needs g++ as it needs nvcc.  Importing the package
builds and loads nothing.

A wrapper returns None only where its docstring says so: an input for
which its caller keeps its own alternative.  Every other negative return
of the C code is an output-capacity overflow that the wrapper's own
sizing rules out, and raises ``RuntimeError`` naming the call.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(__file__)
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(_BUILD, "liblra_native.so")
_lib = None
_load_lock = threading.Lock()

# Bumped whenever an existing exported C signature changes; _load refuses
# a .so reporting a different version (a foreign or stale prebuilt
# library would otherwise be called through mismatched argtypes).
_ABI_VERSION = 5


def _build() -> None:
    """make the library (a no-op when fresh); raises with its output."""
    cmd = ["make", "-C", _DIR, "-s", f"OUT={_SO}"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {_SO} failed ({' '.join(cmd)}): "
                           f"{e}") from e
    if r.returncode != 0:
        raise RuntimeError(
            f"building {_SO} failed ({' '.join(cmd)}, exit "
            f"{r.returncode}):\n{r.stdout}{r.stderr}")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # serialize first-touch: concurrent pool threads (threaded index
    # build, stream workers) and processes on one checkout (test workers)
    # must not race a parallel `make` on the same .so or CDLL a partially
    # written library
    with _load_lock:
        if _lib is not None:
            return _lib
        os.makedirs(_BUILD, exist_ok=True)
        with open(_SO + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            _build()
            try:
                lib = ctypes.CDLL(_SO)
            except OSError as e:
                raise RuntimeError(f"cannot load {_SO}: {e}") from e
        try:
            lib.lrn_abi_version.restype = ctypes.c_int
            lib.lrn_abi_version.argtypes = []
            version = lib.lrn_abi_version()
            if version != _ABI_VERSION:
                raise RuntimeError(
                    f"{_SO} reports ABI version {version}, this package "
                    f"expects {_ABI_VERSION}")
            _bind(lib)
        except AttributeError as e:
            raise RuntimeError(f"{_SO} lacks a symbol: {e}") from e
        _lib = lib
        return _lib


def _fits(n: int, call: str) -> int:
    """n, a C call's count; raises on its capacity-overflow return."""
    if n < 0:
        raise RuntimeError(f"{call}: output capacity exceeded")
    return n


def _bind(lib) -> None:
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
    lib.lrn_refine_windows.restype = ctypes.c_int64
    lib.lrn_refine_windows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.lrn_refine_dp_windowed.restype = ctypes.c_int64
    lib.lrn_refine_dp_windowed.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.lrn_refine_dp.restype = ctypes.c_int64
    lib.lrn_refine_dp.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]


def cigar_string(codes: np.ndarray, lens: np.ndarray,
                 op_chars: str):
    """CIGAR text from op-run arrays (codes index op_chars, lens are the
    run lengths).  A run takes at most 20 of its 24 bytes."""
    lib = _load()
    n = len(codes)
    buf = ctypes.create_string_buffer(24 * max(1, n))
    ln = lib.lrn_cigar_string(
        np.ascontiguousarray(codes, np.uint8)
        .ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(lens, np.int64)
        .ctypes.data_as(ctypes.c_void_p),
        n, op_chars.encode(), buf, len(buf))
    return buf.raw[:_fits(ln, "lrn_cigar_string")].decode()


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
    """Decode a [B, L4] bucket of 2-bit packed device-traceback planes in
    one C pass (the blocks of affine_kernel.blocks_from_ops_batch(
    unpack_ops(plane, False))): returns (flat int32[total, 3] COPY,
    counts int32[B]) — job b's blocks are flat[offs[b]:offs[b]+counts[b]]
    with offs = cumsum exclusive.  The gap-align round lays them into its
    table's CSR of solved blocks (pipeline/gap_align.solve_gap_jobs) as
    they come.  Real planes average ~10-60 blocks a row, so the output
    starts small and grows on overflow up to the hard cap: a row of
    4*L4 ops holds at most 2*L4 match runs, so hard_cap always fits."""
    lib = _load()
    packed = np.ascontiguousarray(packed, np.uint8)
    B, L4 = packed.shape
    counts = np.empty(B, np.int32)
    hard_cap = B * (2 * L4 + 1)
    cap = min(96, 2 * L4 + 1) * B + 1024
    while True:
        out = _scratch_i32(cap * 3)
        total = lib.lrn_blocks_packed(
            packed.ctypes.data_as(ctypes.c_void_p), B, L4,
            out.ctypes.data_as(ctypes.c_void_p), cap,
            counts.ctypes.data_as(ctypes.c_void_p))
        if total >= 0 or cap >= hard_cap:
            break
        cap = min(cap * 8, hard_cap)
    _fits(total, "lrn_blocks_packed")
    # copy out of the shared scratch: the next bucket's decode reuses it
    return out[:total * 3].reshape(-1, 3).copy(), counts


def score_ops(codes: np.ndarray, lens: np.ndarray, logtab: np.ndarray):
    """Stats + NV value over op-run arrays.  Returns (icounts int64[12],
    value float).  The value accumulates in f32, sequentially in op
    order (the reference's own walk, Alignment.h:54,467-504)."""
    lib = _load()
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
    """Merged CIGAR op runs of a block list (align/cigar.
    blocks_to_op_arrays).  blocks: [n,3] int64 ascending.  Returns
    (codes uint8, lens int64)."""
    lib = _load()
    blocks = np.ascontiguousarray(blocks, np.int64)
    read = np.ascontiguousarray(read, np.uint8)
    chrom = np.ascontiguousarray(chrom, np.uint8)
    nb = len(blocks)
    if nb == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    # a run is >= 1 base of a block or of a join's commonGap span, or one
    # of a join's two gap runs: that bounds the runs of any block list
    ln = blocks[:, 2]
    common = np.minimum(blocks[1:, 0] - (blocks[:-1, 0] + ln[:-1]),
                        blocks[1:, 1] - (blocks[:-1, 1] + ln[:-1]))
    cap = int(np.maximum(ln, 0).sum() + np.maximum(common, 0).sum()) \
        + 2 * nb + 4
    codes = np.empty(cap, np.uint8)
    lens = np.empty(cap, np.int64)
    n = lib.lrn_op_arrays(
        blocks.ctypes.data_as(ctypes.c_void_p), nb,
        read.ctypes.data_as(ctypes.c_void_p),
        chrom.ctypes.data_as(ctypes.c_void_p),
        1 if show_mismatch else 0,
        codes.ctypes.data_as(ctypes.c_void_p),
        lens.ctypes.data_as(ctypes.c_void_p), cap)
    n = _fits(n, "lrn_op_arrays")
    return codes[:n].copy(), lens[:n].copy()


def plan_indel_regions(blocks: np.ndarray, read: np.ndarray,
                       chrom: np.ndarray, max_gap: int, span_cap: int,
                       diag_ok: bool, refine_band: int):
    """Indel-refine region planner + trivial-region classifier (see
    align/indel_refine.queue_indel_refine_jobs).  blocks: [n,3] int64
    ascending.  Returns int64 [nreg, 10] rows (lo, hi, trim0, keep1, q0,
    t0, q1, t1, band, kind) — kind 0 = identity skip, 1 = refine job,
    2 = tiny linear job.  Each region moves the walk past >= 1 block, so
    n + 1 rows always fit."""
    lib = _load()
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
    return out[:_fits(nreg, "lrn_plan_indel_regions")]


def banded_align(q: np.ndarray, t: np.ndarray, K: int, kband: int,
                 m: int, mm: int, indel: int):
    """Banded-global alignment of one problem (scalar mirror of
    ops/affine_kernel.banded_global_np + traceback_banded — identical
    blocks).  Returns (blocks list, score).  A traceback step consumes a
    base of q or t, so len(q) + len(t) + 2 blocks always fit."""
    lib = _load()
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
    tr = out[:_fits(nb, "lrn_banded_align") * 3].reshape(-1, 3)
    return ([(int(a), int(b), int(c)) for a, b, c in tr],
            int(score.value))


def load_seqs(path: str, want_quals: bool = False):
    """Native FASTA/FASTQ(.gz) loader.

    Returns (names, offsets int64[n+1], codes uint8, quals|None); raises
    IOError on a file it cannot read.
    """
    lib = _load()
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
    """Minimizer extraction.  exact=True uses the reference's streaming
    emission semantics (lrn_minimizers_ref), exact=False the
    leftmost-tie-break windowed-minimum rule."""
    lib = _load()
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
    n = _fits(n, "lrn_minimizers")
    return tup[:n].copy(), pos[:n].copy(), strand[:n].copy()


def linear_extend(read: np.ndarray, chrom: np.ndarray, q: np.ndarray,
                  t: np.ndarray, strand: int, K: int, pts):
    """Linear anchor extension walk (align/extend.linear_extend_cluster).

    q/t: diagonal-sorted int64 anchor starts; pts: [(coord, is_t)].
    Returns (out_q, out_t, out_len, out_ovp)."""
    lib = _load()
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
    """Per-window local index build (index/local_index).  Returns (tuples u64, pos u32, tuple_bounds i64[nwin+1])."""
    lib = _load()
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
    total = _fits(total, "lrn_local_index_build")
    return tup[:total].copy(), pos[:total].copy(), bounds


def local_reseed(genome_li, rli, ls: int, le: int, chrom_off: int,
                 read_len: int, max_freq: int, margin: int,
                 t_sorted: np.ndarray, q_by_t: np.ndarray,
                 qend_by_t: np.ndarray, lowacc_walk: bool,
                 min_dn: int, max_dn: int, qlo: int, qhi: int,
                 tlo: int, thi: int):
    """Per-cluster local-index reseeding walk (pipeline/refine).
    lowacc_walk selects the Refine_splitchain per-window read range
    (strict window bounds, min qStart / max qEnd over the range) vs the
    REFINEclusters endpoint rule.  Returns (qpos i64, tpos i64)."""
    lib = _load()
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
    (lut int64[nb+1], shift, nb), or None for an index under _LUT_MIN_NI
    rows, where match_batch's plain binary search (lut=None) wins."""
    if len(it) < _LUT_MIN_NI:
        return None
    lib = _load()
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
    """Batched anchor intersection (CompareLists analog).

    qt/qp/qs: concatenated per-read minimizer tuples/positions/strands;
    read_off: int64[n_reads+1] read boundaries; it/ip/istr/ifr: the
    sorted global index arrays.  Returns (qpos, tpos, freq, is_rev,
    read_start): per read, its minimizers stable-sorted by tuple, those
    of multiplicity <= max_freq expanded over their index rows.  A call
    that overflows reports the exact count, so the retry fits."""
    lib = _load()
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
    raise RuntimeError("lrn_match_batch: output capacity exceeded")


def counting_argsort_i32(keys: np.ndarray, max_range: int = 1 << 20):
    """Stable counting argsort for small-range int32 keys.  Returns None
    when max - min of the keys reaches max_range (the sort would allocate
    that many counters); the caller then sorts with np.argsort."""
    lib = _load()
    keys = np.ascontiguousarray(keys, np.int32)
    out = np.empty(len(keys), np.int64)
    rc = lib.lrn_counting_argsort_i32(
        keys.ctypes.data_as(ctypes.c_void_p), len(keys), max_range,
        out.ctypes.data_as(ctypes.c_void_p))
    return None if rc != 0 else out


def refine_dp(q: np.ndarray, t: np.ndarray, K: int, kband: int,
              m: int, mm: int, indel: int):
    """Refine-lane banded DP + traceback for one long indel-refine
    region (C mirror of ops/affine_kernel.banded_refine_np +
    traceback_refine, identical recurrence/tie order).  Returns blocks
    as an int64 [n, 3] array of (q_off, t_off, len).  The traceback
    emits at most one block per op plus one, and an op consumes a base,
    so len(q) + len(t) + 2 blocks always fit."""
    lib = _load()
    q = np.ascontiguousarray(q, np.int8)
    t = np.ascontiguousarray(t, np.int8)
    cap = len(q) + len(t) + 2
    out = np.empty((cap, 3), np.int64)
    nb = lib.lrn_refine_dp(
        q.ctypes.data_as(ctypes.c_void_p), len(q),
        t.ctypes.data_as(ctypes.c_void_p), len(t),
        K, kband, m, mm, indel,
        out.ctypes.data_as(ctypes.c_void_p), cap)
    return out[:_fits(nb, "lrn_refine_dp")].copy()


def refine_dp_shaped(q: np.ndarray, t: np.ndarray, path: np.ndarray,
                     k: int, m: int, mm: int, indel: int):
    """Shaped-band refine DP: per-row q windows dilated from the
    region's existing block path (the reference's qS/qE geometry,
    IndelRefine.h:219-330, as a slightly wider superset).  path:
    [n,3] int64 job-local (q,t,len) triples spanning (0,0)..(qlen,tlen).
    Returns blocks as an int64 [n, 3] array of (q_off, t_off, len), or
    None on a degenerate region (empty q, t or path), which the caller
    solves with the rectangular refine_dp.  Blocks fit as in refine_dp."""
    lib = _load()
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
    return None if nb < 0 else out[:nb].copy()


def refine_windows(path: np.ndarray, qlen: int, tlen: int, k: int):
    """The shaped band's row windows for a region of qlen x tlen with
    block path ``path`` (refine_dp_shaped's first phase): (qlo, qhi),
    int32 [tlen + 1] each, row j covering q in [qlo[j], qhi[j]].  None on
    a degenerate region (empty q, t or path): the caller keeps that row
    off the shaped kernel."""
    lib = _load()
    path = np.ascontiguousarray(path, np.int64)
    qlo = np.empty(tlen + 1, np.int32)
    qhi = np.empty(tlen + 1, np.int32)
    cells = lib.lrn_refine_windows(
        path.ctypes.data_as(ctypes.c_void_p), len(path), qlen, tlen, k,
        qlo.ctypes.data_as(ctypes.c_void_p),
        qhi.ctypes.data_as(ctypes.c_void_p))
    return None if cells < 0 else (qlo, qhi)


def refine_dp_windowed(q: np.ndarray, t: np.ndarray, qlo: np.ndarray,
                       qhi: np.ndarray, m: int, mm: int, indel: int):
    """refine_dp_shaped's second phase: the DP and traceback over the
    row windows of refine_windows (which are never degenerate).  Returns
    blocks as refine_dp_shaped does."""
    lib = _load()
    q = np.ascontiguousarray(q, np.int8)
    t = np.ascontiguousarray(t, np.int8)
    qlo = np.ascontiguousarray(qlo, np.int32)
    qhi = np.ascontiguousarray(qhi, np.int32)
    cap = len(q) + len(t) + 2
    out = np.empty((cap, 3), np.int64)
    nb = lib.lrn_refine_dp_windowed(
        q.ctypes.data_as(ctypes.c_void_p), len(q),
        t.ctypes.data_as(ctypes.c_void_p), len(t),
        qlo.ctypes.data_as(ctypes.c_void_p),
        qhi.ctypes.data_as(ctypes.c_void_p), m, mm, indel,
        out.ctypes.data_as(ctypes.c_void_p), cap)
    return out[:_fits(nb, "lrn_refine_dp_windowed")].copy()
