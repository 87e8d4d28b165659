"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
``_build/lib<name>.so`` with a plain C interface, loaded with ctypes
(no PyTorch headers, so a build takes seconds).  The first kernel call
of a process builds every stale source at once, one nvcc process per
source, all started together.  A build failure raises with nvcc's log;
nothing here falls back to a kernel's plain torch twin.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` passes the calling thread's current
CUDA stream, raises when the entry point returns other than 0, and
counts the launch under the kernel's name in ``LAUNCHES``.  A run resets
the counts with ``reset_launches`` and reads them afterwards to show
which kernels its path went through.  Launches may come from several
threads at once (the ``-t N`` pool of pipeline/stream.py, each thread on
its own stream): the counts, the loaded libraries and the entry points
are read and written under one lock.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading

import torch

from ..utils import devstats

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("sdp_blocked", "banded_global", "banded_refine", "one_gap",
           "chain_mask", "sdp_windowed")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per kernel since the last reset_launches()
LAUNCHES = {"chain_scores_blocked": 0, "banded_global_traced_packed": 0,
            "banded_refine_traced_packed": 0, "banded_pallas_rowsync": 0,
            "one_gap_traced": 0, "chain_mask_from_scores": 0,
            "chain_scores_windowed": 0, "chain_scores": 0,
            "banded_global_kernel": 0}

_libs: dict = {}
_lock = threading.RLock()


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): cannot build the CUDA "
                           "kernels")
    return exe


def _stale(name: str) -> bool:
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if not os.path.exists(so):
        return True
    t = os.path.getmtime(so)
    deps = [os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
            if f == f"{name}.cu" or f.endswith(".cuh")]
    return any(os.path.getmtime(d) > t for d in deps)


def build_all() -> dict:
    """Compile every stale source in parallel; returns {name: seconds of
    its nvcc run} for the sources built (empty when all were fresh)."""
    import time

    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in SOURCES if _stale(n)]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = os.path.join(BUILD_DIR, f"lib{n}.so.tmp{os.getpid()}")
        log = open(os.path.join(BUILD_DIR, f"{n}.log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=log,
                                     stderr=subprocess.STDOUT), tmp, log)
    took = {}
    failed = []
    for n, (p, tmp, log) in procs.items():
        rc = p.wait()
        log.close()
        took[n] = time.perf_counter() - t0
        if rc != 0:
            failed.append(n)
            continue
        os.replace(tmp, os.path.join(BUILD_DIR, f"lib{n}.so"))
    if failed:
        msgs = []
        for n in failed:
            with open(os.path.join(BUILD_DIR, f"{n}.log")) as f:
                msgs.append(f"--- {n}.cu ---\n{f.read()[-4000:]}")
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return took


def _lib(name: str):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            for n in SOURCES:
                if n not in _libs:
                    L = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{n}.so"))
                    L.lra_errstr.restype = ctypes.c_char_p
                    L.lra_errstr.argtypes = [ctypes.c_int]
                    _libs[n] = L
            lib = _libs[name]
        return lib


_entries: dict = {}


def _entry(lib: str, fn: str, argtypes: list):
    """C entry point ``fn`` of lib<lib>.so with its signature set (once)."""
    key = (lib, fn)
    with _lock:
        f = _entries.get(key)
        if f is None:
            f = getattr(_lib(lib), fn)
            f.restype = ctypes.c_int
            f.argtypes = list(argtypes) + [ctypes.c_void_p]
            _entries[key] = f
    return f


def launch(kernel: str, lib: str, fn: str, argtypes: list, *args) -> None:
    """Call C entry point ``fn`` of lib<lib>.so (last argument: the
    calling thread's current CUDA stream, appended here) and raise on a
    launch error.  With device-round statistics on (utils/devstats.py),
    CUDA events on that stream bracket the call."""
    f = _entry(lib, fn, argtypes)
    stream = torch.cuda.current_stream()
    if devstats.ENABLED:
        rc = devstats.timed_launch(f, args, stream)
    else:
        rc = f(*args, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc}: "
                           f"{_lib(lib).lra_errstr(rc).decode()})")
    with _lock:
        LAUNCHES[kernel] += 1


SMEM_MAX = 232448   # shared memory a block may use on sm_90


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index` (the launch plans'
    card size)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    """Raise unless t is a contiguous CUDA tensor of the given dtype and
    (where given) shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
