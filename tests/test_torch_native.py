"""The port's native host library is built, loaded, or the call raises:
a failed build, a library a failed rebuild left behind, a library that
cannot be loaded, lacks a symbol or reports another ABI version each
raise RuntimeError, concurrent first loads share one build, and
importing the package builds nothing.  Each case builds into its own
temporary directory, so the library the rest of the suite loads is never
touched.  Also the wrappers' documented None
returns, and the op-run buffer's sizing for any block list."""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from lra_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def real_so():
    """The suite's own library, built and loaded the usual way."""
    native._load()
    return native._SO


@pytest.fixture
def tmp_lib(tmp_path, monkeypatch):
    """native's build directory and library path moved to tmp_path, with
    nothing loaded; returns the temporary library path."""
    so = str(tmp_path / "liblra_native.so")
    monkeypatch.setattr(native, "_BUILD", str(tmp_path))
    monkeypatch.setattr(native, "_SO", so)
    monkeypatch.setattr(native, "_lib", None)
    return so


def test_failed_build_raises_with_make_output(tmp_lib, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError) as e:
        native.cigar_string(np.zeros(1, np.uint8), np.ones(1, np.int64),
                            "=XID")
    msg = str(e.value)
    assert tmp_lib in msg and "make" in msg
    # make's own report of the failed recipe
    assert "Error" in msg
    assert native._lib is None
    assert not os.path.exists(tmp_lib)


def test_stale_library_is_not_loaded_after_failed_rebuild(tmp_lib,
                                                          monkeypatch):
    # a library older than lra_native.cpp, so make rebuilds it, and the
    # rebuild fails: the stale file must not be loaded
    with open(tmp_lib, "w") as f:
        f.write("stale library\n")
    os.utime(tmp_lib, (0, 0))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building"):
        native._load()
    assert native._lib is None
    assert os.path.getmtime(tmp_lib) == 0


def test_abi_mismatch_raises_naming_both_versions(real_so, tmp_lib,
                                                  monkeypatch):
    # a fresh copy of the real library (make has nothing to do), read
    # against a version this package does not expect
    shutil.copyfile(real_so, tmp_lib)
    wrong = native._ABI_VERSION + 1000
    monkeypatch.setattr(native, "_ABI_VERSION", wrong)
    with pytest.raises(RuntimeError) as e:
        native._load()
    msg = str(e.value)
    assert tmp_lib in msg
    assert f"ABI version {wrong - 1000}" in msg and f"expects {wrong}" in msg
    assert native._lib is None


def test_unloadable_library_raises(tmp_lib):
    with open(tmp_lib, "w") as f:
        f.write("not a shared library\n")
    with pytest.raises(RuntimeError, match="cannot load"):
        native._load()
    assert native._lib is None


def test_library_missing_a_symbol_raises(tmp_lib):
    # a library with the expected ABI version and no other symbol
    src = 'extern "C" int lrn_abi_version() { return %d; }\n' \
        % native._ABI_VERSION
    subprocess.run(["g++", "-shared", "-fPIC", "-x", "c++", "-", "-o",
                    tmp_lib], input=src, text=True, check=True,
                   capture_output=True, timeout=60)
    with pytest.raises(RuntimeError, match="lacks a symbol"):
        native._load()
    assert native._lib is None


def test_concurrent_first_loads_share_one_build(tmp_path):
    """Four processes load the library from one empty build directory at
    once: make runs under a file lock, so none loads a half-written
    library or fails on another's build."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from lra_tpu_torch import native
        native._BUILD = sys.argv[1]
        native._SO = sys.argv[1] + "/liblra_native.so"
        print(native.cigar_string(np.zeros(2, np.uint8),
                                  np.array([3, 40], np.int64), "=XID"))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "3=40="


def test_import_builds_and_loads_nothing():
    """Importing every module of the package leaves the library unloaded
    (so make never ran)."""
    code = textwrap.dedent("""
        import importlib, pkgutil
        import lra_tpu_torch
        for m in pkgutil.walk_packages(lra_tpu_torch.__path__,
                                       "lra_tpu_torch."):
            importlib.import_module(m.name)
        from lra_tpu_torch import native
        assert native._lib is None, native._lib
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_documented_none_returns():
    """The Nones the wrappers' docstrings name, each an input for which
    the caller keeps its own alternative."""
    keys = np.array([0, 1 << 22, 5], np.int32)
    assert native.counting_argsort_i32(keys) is None
    assert native.counting_argsort_i32(keys, 1 << 23).tolist() == [0, 2, 1]
    empty = np.zeros((0, 3), np.int64)
    assert native.refine_windows(empty, 5, 5, 3) is None
    q = np.zeros(5, np.int8)
    assert native.refine_dp_shaped(q, q, empty, 3, 4, -3, -4) is None
    assert native.match_lut_build(np.arange(10, dtype=np.uint64), 20) is None


def test_capacity_overflow_raises_naming_the_call():
    assert native._fits(3, "lrn_x") == 3
    with pytest.raises(RuntimeError, match="lrn_x: output capacity"):
        native._fits(-1, "lrn_x")


def test_op_arrays_sized_for_overlapping_blocks():
    """Three copies of one block, alternating match and mismatch: 300
    runs, past the blocks' q + t extent (200), fit the buffer."""
    read = np.zeros(100, np.uint8)
    chrom = np.tile(np.array([0, 1], np.uint8), 50)
    blocks = np.array([[0, 0, 100]] * 3, np.int64)
    codes, lens = native.op_arrays(blocks, read, chrom, True)
    assert len(codes) == 300
    assert codes.tolist() == [0, 1] * 150
    assert lens.tolist() == [1] * 300
