"""Local (per-window) minimizer index.

Equivalent of the reference's ``LocalIndex`` (reference: MMIndex.h:100-256):
non-canonical k<=10, w=5 minimizers per ``local_index_window`` (2048bp —
the reference's LocalIndex default-constructor window, MMIndex.h:110-117;
see Options.local_index_window)
sequence window, sorted by tuple within the window, per-window frequency
cap.  Stored as flat arrays (tuples/pos are window-relative) plus window
boundary offsets — directly shardable/replicable.

Used on the genome (built offline) and per read + its RC (built on the fly,
reference: Map_highacc.h:398-402).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native


@dataclass
class LocalIndex:
    k: int
    w: int
    window: int
    max_freq: int
    tuples: np.ndarray          # uint64, sorted within each window
    pos: np.ndarray             # uint32 window-relative positions
    seq_offsets: np.ndarray     # int64[nwin+1] absolute seq offsets
    tuple_bounds: np.ndarray    # int64[nwin+1] row bounds per window

    def nwindows(self) -> int:
        return len(self.tuple_bounds) - 1

    def lookup_window(self, seq_pos: int) -> int:
        """Window index containing seq_pos (reference: LookupIndex)."""
        i = int(np.searchsorted(self.seq_offsets, seq_pos, side="left"))
        if i >= len(self.seq_offsets) or self.seq_offsets[i] != seq_pos:
            return max(0, i - 1)
        return i

    def save(self, path: str) -> None:
        np.savez(path, k=self.k, w=self.w, window=self.window,
                 max_freq=self.max_freq, tuples=self.tuples, pos=self.pos,
                 seq_offsets=self.seq_offsets, tuple_bounds=self.tuple_bounds)

    @classmethod
    def load(cls, path: str) -> "LocalIndex":
        z = np.load(path)
        return cls(int(z["k"]), int(z["w"]), int(z["window"]),
                   int(z["max_freq"]), z["tuples"], z["pos"],
                   z["seq_offsets"], z["tuple_bounds"])


def build_local_index(codes: np.ndarray, k: int = 10, w: int = 5,
                      window: int = 2048, max_freq: int = 15,
                      offset: int = 0, exact: bool = True) -> LocalIndex:
    """Index one sequence (a chromosome or a read), in the native library:
    per window, minimizers sorted by tuple, runs of a tuple kept only
    while count < max_freq (reference: RemoveFrequent, MMIndex.h:70-85).

    ``offset`` shifts seq_offsets into a global coordinate space so
    chromosome indexes can be concatenated (reference: IndexSeq offset).
    ``exact`` selects the reference streaming minimizer semantics
    (MinCount.h; see index/minimizers.py) — genome- and read-side local
    indexes must use the same setting.
    """
    n = len(codes)
    nwin = (n + window - 1) // window

    tup, pos, bounds = native.local_index_build(codes, k, w, window,
                                                max_freq, exact)
    seq_offsets = offset + np.minimum(
        np.arange(nwin + 1, dtype=np.int64) * window, n)
    return LocalIndex(k, w, window, max_freq, tup, pos, seq_offsets, bounds)


def build_genome_local_index(genome, k: int = 10, w: int = 5,
                             window: int = 2048, max_freq: int = 15,
                             threads: int = 1,
                             exact: bool = True) -> LocalIndex:
    """Concatenated per-chromosome local index in global coordinates.

    threads > 1 builds chromosomes in parallel (the native builder is a
    ctypes call, GIL released); collection order is chromosome order, so
    the result is identical at any thread count.  ``exact`` must match
    the read-side local-index builds (Options.exact_ref_minimizers).
    """

    def _one(ci: int):
        start = 0 if ci == 0 else int(genome.ends[ci - 1])
        end = int(genome.ends[ci])
        return build_local_index(genome.codes[start:end], k, w,
                                 window, max_freq, offset=start,
                                 exact=exact)

    if threads > 1 and genome.nseq > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=threads) as ex:
            parts = list(ex.map(_one, range(genome.nseq)))
    else:
        parts = [_one(ci) for ci in range(genome.nseq)]
    if not parts:
        return build_local_index(np.zeros(0, np.uint8), k, w, window,
                                 max_freq)
    tuples = np.concatenate([p.tuples for p in parts])
    pos = np.concatenate([p.pos for p in parts])
    seq_offsets = [0]
    tuple_bounds = [0]
    for p in parts:
        seq_offsets.extend(p.seq_offsets[1:].tolist())
        base = tuple_bounds[-1]
        tuple_bounds.extend((p.tuple_bounds[1:] + base).tolist())
    return LocalIndex(k, w, window, max_freq, tuples, pos,
                      np.asarray(seq_offsets, np.int64),
                      np.asarray(tuple_bounds, np.int64))
