"""The indel-refine round's long shaped-band regions on the card.

A region of the indel-refine round past ``refine_dev_max`` rows that
carries its block path is solved over the shaped band's row windows
(``native.refine_windows``: row j covers q in [qlo[j], qhi[j]], the
reference's qS/qE geometry).  ``solve`` takes a round's such regions at
once: on CUDA tensors the hand kernel ``refine_shaped_kernel``
(csrc/banded_refine.cu: K5's recurrence, exchange, plane byte and walk
over the windows, one block a region, a warp per 32 cells of its widest
row, one plane byte a window cell, the traceback on the card, only
blocks coming back); on CPU tensors its twin, the host C DP over the
same windows (``native.refine_dp_windowed``, the second phase of
``native.refine_dp_shaped``), region by region.  Both give the C DP's
blocks exactly.  A region's blocks are bounded as the C wrapper's are
(``block_cap``), so none is ever cut short.

``route`` is the rule the round applies first: a region goes to the
kernel when its widest row fits the kernel's block (``MAX_WIDTH``
cells) and no score can pass f32's exact integers on the match side.
The kernel still checks every score it forms: a region in which one
passes the limit gets count -2, and ``fetch_blocks`` raises on it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from . import _ext

MAX_WIDTH = 512                # widest window row: 16 warps (csrc: SH_MAXW)
META = 7                       # int64 a region (csrc: struct Region)
_ALIGN = 16


def block_cap(qlen: int, tlen: int) -> int:
    """Blocks a region's walk can emit, the C wrapper's cap: at most one
    a step of its qlen + tlen steps, one after the last and one for an
    empty walk."""
    return qlen + tlen + 2


def warps(maxw: int) -> int:
    """Warps of the kernel's block for a region whose widest row has
    `maxw` cells: one per 32 cells, rounded up to an instantiated count
    (1-6, 8 or 16; csrc: shaped_warps)."""
    n = -(-maxw // 32)
    return n if n <= 6 else (8 if n <= 8 else MAX_WIDTH // 32)


def exact_limit(m: int, mm: int, indel: int) -> float:
    """The largest score magnitude under which every sum the kernel's row
    forms (a neighbour's S plus a step's score, the linear closure's
    indel * x for x < MAX_WIDTH) is an integer f32 holds exactly."""
    step = max(abs(m), abs(mm), abs(indel), abs(2 * indel + 1))
    return float(2 ** 24 - abs(indel) * MAX_WIDTH - 2 * step - 1)


def route(qlen: int, tlen: int, width: int, m: int, mm: int,
          indel: int) -> bool:
    """True when the kernel takes a region: its widest row has at most
    MAX_WIDTH cells, and m per matched base cannot pass exact_limit."""
    return (width <= MAX_WIDTH
            and abs(m) * min(qlen, tlen) < exact_limit(m, mm, indel))


@dataclass
class Packed:
    """A round's regions in one host buffer, sections 16-byte aligned:
    meta int64 [R, 7] (q offset, t offset, qlen, tlen, first row, plane
    offset, blocks offset), maxw int32 [R] (the widest row), qlo
    int32 and wid int16 (a row each), q and t int8.  ``host`` is the
    buffer as a tensor (pinned for a card: its copy then waits for
    nothing queued before it on the stream), ``buf`` its numpy view."""
    host: torch.Tensor
    buf: np.ndarray
    sections: dict            # name -> (byte offset, dtype, count)
    R: int
    rows: int                 # window rows (tlen + 1 a region)
    cells: int                # window cells = plane bytes
    caps: np.ndarray          # int64 [R]
    boff: np.ndarray          # int64 [R]: first block of each region

    def view(self, name: str) -> np.ndarray:
        off, dt, n = self.sections[name]
        return self.buf[off:off + n * np.dtype(dt).itemsize].view(dt)


def pack(regions, pin: bool = False) -> Packed:
    """regions: (q, t, qlo, qhi) per region, codes int8 and windows int32
    [tlen + 1] of native.refine_windows; pin: the buffer in pinned host
    memory (for a card)."""
    R = len(regions)
    if R == 0:
        raise ValueError("pack: no region")
    ql = np.array([len(r[0]) for r in regions], np.int64)
    tl = np.array([len(r[1]) for r in regions], np.int64)
    wids = [r[3] - r[2] + 1 for r in regions]
    maxw = [int(w.max()) for w in wids]
    if max(maxw) > MAX_WIDTH:
        raise ValueError(f"a row of {max(maxw)} cells, past {MAX_WIDTH}")
    cells_r = np.array([int(w.sum(dtype=np.int64)) for w in wids], np.int64)
    caps = np.array([block_cap(int(a), int(b)) for a, b in zip(ql, tl)],
                    np.int64)
    boff = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int64)
    rows = int((tl + 1).sum())
    sizes = {"meta": (np.int64, R * META), "maxw": (np.int32, R),
             "qlo": (np.int32, rows), "wid": (np.int16, rows),
             "q": (np.int8, int(ql.sum())), "t": (np.int8, int(tl.sum()))}
    sections, at = {}, 0
    for name, (dt, n) in sizes.items():
        sections[name] = (at, dt, n)
        at += -(-n * np.dtype(dt).itemsize // _ALIGN) * _ALIGN
    host = torch.empty(at, dtype=torch.uint8, pin_memory=pin)
    p = Packed(host, host.numpy(), sections, R, rows, int(cells_r.sum()),
               caps, boff)
    qoff = np.concatenate([[0], np.cumsum(ql)[:-1]])
    toff = np.concatenate([[0], np.cumsum(tl)[:-1]])
    woff = np.concatenate([[0], np.cumsum(tl + 1)[:-1]])
    poff = np.concatenate([[0], np.cumsum(cells_r)[:-1]])
    meta = p.view("meta").reshape(R, META)
    meta[:] = np.stack([qoff, toff, ql, tl, woff, poff, boff], 1)
    p.view("maxw")[:] = maxw
    p.view("qlo")[:] = np.concatenate([r[2] for r in regions])
    p.view("wid")[:] = np.concatenate(wids)
    p.view("q")[:] = np.concatenate([r[0] for r in regions])
    p.view("t")[:] = np.concatenate([r[1] for r in regions])
    return p


def solve(p: Packed, m: int, mm: int, indel: int, device):
    """The round's regions solved on ``device``: (counts int32 [R], blocks
    int32 [sum caps, 3]), region r's count blocks (q, t, len), relative
    to its start, at rows boff[r] on.  On CUDA the kernel's launch is
    queued on the calling thread's stream and its scratch (the plane) is
    freed when this returns."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return _solve_cuda(p, m, mm, indel, dev)
    return _solve_twin(p, m, mm, indel)


_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float]
         + [ctypes.c_int])


def _solve_cuda(p: Packed, m, mm, indel, dev):
    buf = p.host.to(dev, non_blocking=p.host.is_pinned())
    ptr = buf.data_ptr()
    at = {k: ptr + v[0] for k, v in p.sections.items()}
    plane = torch.empty(p.cells + _ALIGN, dtype=torch.uint8, device=dev)
    out = torch.empty((int(p.caps.sum()), 3), dtype=torch.int32, device=dev)
    counts = torch.empty(p.R, dtype=torch.int32, device=dev)
    _ext.launch("refine_shaped", "banded_refine", "lra_refine_shaped",
                _ARGS, at["q"], at["t"], at["qlo"], at["wid"], at["meta"],
                at["maxw"], plane.data_ptr(), out.data_ptr(),
                counts.data_ptr(), p.R, int(m), int(mm), int(indel),
                exact_limit(m, mm, indel), warps(int(p.view("maxw").max())))
    return counts, out


def _solve_twin(p: Packed, m, mm, indel):
    meta = p.view("meta").reshape(-1, META)
    qlo, wid = p.view("qlo"), p.view("wid")
    q, t = p.view("q"), p.view("t")
    counts = np.empty(p.R, np.int32)
    out = np.zeros((int(p.caps.sum()), 3), np.int32)
    for r in range(p.R):
        qo, to, ql, tl, wo, _po, bo = (int(v) for v in meta[r])
        lo = qlo[wo:wo + tl + 1]
        bl = native.refine_dp_windowed(q[qo:qo + ql], t[to:to + tl], lo,
                                       lo + wid[wo:wo + tl + 1] - 1, m, mm,
                                       indel)
        counts[r] = len(bl)
        out[bo:bo + len(bl)] = bl
    return torch.from_numpy(counts), torch.from_numpy(out)


def fetch_blocks(p: Packed, counts: np.ndarray, out: torch.Tensor) -> list:
    """Region r's blocks, int64 [n, 3]: the blocks alone come back, in one
    copy.  Raises on a region the kernel gave up on (count -2: a score
    past f32's exact integers)."""
    bad = np.nonzero(np.asarray(counts) < 0)[0]
    if len(bad):
        raise RuntimeError(
            f"refine_shaped: {len(bad)} region(s) with a score past f32's "
            f"exact integers (first: region {int(bad[0])}, "
            f"{int(p.view('meta').reshape(-1, META)[bad[0], 3])} rows)")
    parts = [out[int(p.boff[r]):int(p.boff[r]) + int(n)]
             for r, n in enumerate(counts) if n > 0]
    flat = (torch.cat(parts) if len(parts) > 1 else parts[0]).cpu().numpy() \
        if parts else np.zeros((0, 3), np.int32)
    res, at = [], 0
    for n in counts:
        n = int(n)
        res.append(flat[at:at + n].astype(np.int64))
        at += n
    return res
