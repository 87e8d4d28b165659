"""lra_tpu_torch stands alone: it imports neither jax nor lra_tpu, and
its entry points never fall back from CUDA to the CPU silently."""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax_or_lra_tpu():
    """Every module of the package (and chip_smoke.py) imports in a
    process where jax is unimportable and any lra_tpu import raises."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys
        sys.modules["jax"] = None

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "lra_tpu" or name.startswith("lra_tpu."):
                    raise ImportError("port imported " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import lra_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            lra_tpu_torch.__path__, "lra_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        import chip_smoke
        bad = [k for k, v in sys.modules.items() if v is not None and (
               k == "lra_tpu" or k.startswith("lra_tpu.")
               or k == "jax" or k.startswith("jax."))]
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40


def test_cuda_request_without_cuda_raises(monkeypatch):
    from lra_tpu_torch import preset
    from lra_tpu_torch.device import resolve_device
    from lra_tpu_torch.pipeline import align_reads

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        align_reads([], None, None, preset("ccs"), device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_tensors_for_the_cuda_path():
    """The wrappers take the plain twin only for CPU tensors; the CUDA
    entry checks refuse anything but contiguous CUDA tensors."""
    from lra_tpu_torch.ops import _ext

    with pytest.raises(ValueError, match="CUDA"):
        _ext.check("q", torch.zeros(4, dtype=torch.int8), torch.int8)


def test_kernel_stops_table_matches_gapcost():
    """The SDP kernels (K2, K7) compile the PWL breakpoints in from
    csrc/pwl.cuh; they must be gapcost.STOPS."""
    from lra_tpu_torch.ops.gapcost import STOPS

    csrc = os.path.join(ROOT, "lra_tpu_torch", "csrc")
    for name in ("sdp_blocked.cu", "sdp_windowed.cu"):
        assert '#include "pwl.cuh"' in open(os.path.join(csrc, name)).read()
    src = open(os.path.join(csrc, "pwl.cuh")).read()
    body = re.search(r"c_stops\[NPIECE \+ 1\] = \{([^}]*)\}", src).group(1)
    vals = [int(x) for x in body.replace("\n", " ").split(",")]
    assert vals == [int(s) for s in STOPS]
