"""Multi-device execution: a data-parallel mesh and sharded kernel steps.

lra_tpu shards every bucket's batch axis data-parallel over a jax Mesh
(axis 'dp'); the minimizer index and the genome stay on the host.  The
port's ``Mesh`` is a tuple of torch devices.  Under ``use_mesh`` the
kernel drivers (chain/driver.py, pipeline/gap_align.py) hand each bucket
to ``run_sharded``: its [B, ...] arrays split along axis 0 into one
contiguous shard per entry, the kernel's wrapper runs once per shard on
that device's current stream, and the outputs join on the mesh's first
device along their batch axis, after that device's stream has waited on
an event from each shard's stream.  Decisions that depend on B (the
bucket padding, ``batch_multiple``, the row-sync gate) are taken on the
whole bucket, as lra_tpu takes them; each shard's launch plan follows its
own B (the kernels' outputs do not depend on the plan).  A mesh of n
entries launches every kernel n times where one device launches it once.

A device list may repeat an entry.  ``make_mesh(devices=["cpu"] * 8)`` is
the CPU tests' mesh, the port's stand-in for the 8 virtual host devices
that lra_tpu's tests get from xla_force_host_platform_device_count
(tests/conftest.py); ``make_mesh(devices=["cuda:0"] * 4)`` splits every
bucket into four launches on one card.  Without a mesh every function
here behaves as the single-device path always has.

``sharded_chain_scores``, ``sharded_banded_align`` and
``combined_device_step`` are lra_tpu's sharded steps (K2, and K9 with
the full arrow plane) with its signatures and output shapes; their
outputs come back joined on the mesh's first device.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import resolve_device
from ..ops.affine_kernel import banded_global_kernel
from ..ops.gapcost import GapParams
from ..ops.sdp_blocked import chain_scores_blocked


class Mesh:
    """A data-parallel mesh: a tuple of torch devices on axis 'dp'."""

    def __init__(self, devices, axis_names=("dp",)):
        if not len(devices):
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(resolve_device(d) for d in devices)
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over ``devices`` (entries may repeat), else over the first
    n_devices CUDA devices (all of them by default); raises without a
    CUDA device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch sees no CUDA device; pass "
                               "devices=['cpu', ...] for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(devices)


# ---- active mesh: the pipeline's kernel drivers consult this ----
_ACTIVE: list = [None]


def active_mesh() -> Mesh | None:
    return _ACTIVE[0]


class use_mesh:
    """Context manager: run the alignment pipeline with every batched
    kernel's problem axis sharded data-parallel over the mesh.  Only the
    [B, ...] kernel batches move to the mesh's devices.

        with use_mesh(make_mesh()):
            align_reads(reads, genome, idx, opts)
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __enter__(self):
        _ACTIVE[0] = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        _ACTIVE[0] = None
        return False


def batch_multiple(b: int) -> int:
    """Round a batch size up so the mesh's entries divide it (no mesh:
    unchanged)."""
    mesh = _ACTIVE[0]
    if mesh is None:
        return b
    n = mesh.size
    return ((b + n - 1) // n) * n


def _to(a, dev) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev, non_blocking=True)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev,
                                                        non_blocking=True)


def _shards(mesh: Mesh, a) -> tuple:
    n = mesh.size
    B = a.shape[0]
    if B % n:
        raise ValueError(f"batch of {B} rows does not split over a mesh "
                         f"of {n} entries")
    s = B // n
    return tuple(_to(a[k * s:(k + 1) * s], dev)
                 for k, dev in enumerate(mesh.devices))


def shard_batch(mesh: Mesh, *arrays) -> tuple:
    """[B, ...] arrays (numpy or torch) split along axis 0 into one
    contiguous shard per mesh entry, each on its device: a tuple per
    array of its shards."""
    return tuple(_shards(mesh, a) for a in arrays)


def place(a, device="cuda"):
    """A tensor on ``device``; with a mesh active, its shards (axis 0)."""
    mesh = _ACTIVE[0]
    if mesh is None:
        return _to(a, torch.device(device))
    return _shards(mesh, a)


def place_many(*arrays, device) -> tuple:
    """place() for several arrays."""
    return tuple(place(a, device) for a in arrays)


def _on(dev):
    """The device context of a mesh entry (none for the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _join(parts: list, axis: int, dev) -> torch.Tensor:
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(dev, non_blocking=True) for p in parts], dim=axis)


def run_shards(mesh: Mesh, fn, shards, *args, out_axes=0, **kw):
    """fn(*shard k of each of ``shards``, *args, **kw) for every mesh
    entry k, each under its device (on its current stream); the outputs
    (a tensor or a tuple of them) joined on the mesh's first device along
    ``out_axes`` (one axis for all, or one per output), after that
    device's current stream has waited on each shard's stream."""
    outs, events = [], []
    for k, dev in enumerate(mesh.devices):
        with _on(dev):
            outs.append(fn(*(s[k] for s in shards), *args, **kw))
            if dev.type == "cuda":
                events.append(torch.cuda.current_stream(dev).record_event())
    first = mesh.devices[0]
    single = isinstance(outs[0], torch.Tensor)
    per = [(o,) if single else tuple(o) for o in outs]
    axes = out_axes if isinstance(out_axes, tuple) else \
        (out_axes,) * len(per[0])
    with _on(first):
        for ev in events:
            torch.cuda.current_stream(first).wait_event(ev)
        joined = tuple(_join([p[i] for p in per], axes[i], first)
                       for i in range(len(axes)))
    return joined[0] if single else joined


def run_sharded(fn, arrays, *args, device, out_axes=0, **kw):
    """A bucket through its kernel wrapper: fn(*tensors, *args, **kw) on
    the numpy [B, ...] ``arrays``.  Without a mesh, one call on tensors on
    ``device``; with one, run_shards over the active mesh (which then
    decides the devices)."""
    mesh = _ACTIVE[0]
    if mesh is None:
        return fn(*place_many(*arrays, device=device), *args, **kw)
    return run_shards(mesh, fn, shard_batch(mesh, *arrays), *args,
                      out_axes=out_axes, **kw)


def sharded_chain_scores(mesh: Mesh, qS, qE, tS, tE, score, lane1, lane2,
                         valid, gp: GapParams):
    """Blocked chain DP (K2) with the problem batch sharded over the
    mesh: (V, bp, lane) [B, N], joined on the mesh's first device."""
    shards = shard_batch(mesh, qS, qE, tS, tE, score, lane1, lane2, valid)
    return run_shards(mesh, chain_scores_blocked, shards, gp.static_key())


def kband_fifth(kernel):
    """A banded kernel's wrapper, kernel(q, t, qlen, tlen, K, m, mm, indel,
    kband=), as f(q, t, qlen, tlen, kband, K, m, mm, indel): a bucket's
    five arrays first, as run_shards passes them."""
    def call(q, t, qlen, tlen, kband, K, m, mm, indel):
        return kernel(q, t, qlen, tlen, K, m, mm, indel, kband=kband)
    return call


_banded = kband_fifth(banded_global_kernel)


def sharded_banded_align(mesh: Mesh, q, t, qlen, tlen, K, m, mm, indel,
                         kband):
    """K9 with the problem batch sharded over the mesh: (score [B],
    arrows [B, T+1, 2K+1])."""
    if kband is None:
        kband = np.full(q.shape[0], K, np.int32)
    shards = shard_batch(mesh, q, t, qlen, tlen, kband)
    return run_shards(mesh, _banded, shards, K, m, mm, indel)


def combined_device_step(mesh: Mesh, gp: GapParams, m: int, mm: int,
                         indel: int, K: int):
    """The full device side of an alignment step over the mesh: a
    function of (qS, qE, tS, tE, score, lane1, lane2, valid [B, N]; gq
    [B, Q], gt [B, T], gql, gtl, gkb [B]) that runs K2 and K9 on each
    shard and returns (V, bp, lane [B, N], score [B], arrows [B, T+1,
    2K+1]) joined on the mesh's first device (lra_tpu's out_shardings:
    every output split on its first axis)."""
    key = gp.static_key()

    def one(qS, qE, tS, tE, score, lane1, lane2, valid, gq, gt, gql, gtl,
            gkb):
        V, bp, lane = chain_scores_blocked(qS, qE, tS, tE, score, lane1,
                                           lane2, valid, key)
        sc, arrows = _banded(gq, gt, gql, gtl, gkb, K, m, mm, indel)
        return V, bp, lane, sc, arrows

    def step(*arrays):
        return run_shards(mesh, one, shard_batch(mesh, *arrays))

    return step
