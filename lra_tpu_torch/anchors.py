"""Seed matching: read minimizers x global index -> anchors.

Replaces the reference's two-ended gallop intersection
(reference: CompareLists.h:9-146) with a sorted-list lookup and
expansion (native.match_batch for a read batch against the global
index, match_minimizer_lists for the small local lists), and the
per-match literal k-mer re-extraction of ``SeparateMatchesByStrand``
(reference: MapRead.h:110-150) with a strand-bit XOR — equivalent
because two canonical minimizers are literally equal iff their tuples
AND canonical strands agree.

Semantics preserved from CompareLists:
* all (read_pos, genome_pos) pairs with equal canonical tuples are emitted;
* a read tuple whose multiplicity in the read is > max_freq emits nothing
  (reference: CompareLists.h:86 ``qs - qsStart < maxFreq``, i.e. run length
  <= maxFreq emits);
* optional diagonal band filter (used by local-index reseeding).

Reverse matches keep forward-read coordinates here (anti-diagonal
geometry); downstream clustering owns any flips, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import native
from .index.global_index import GlobalIndex
from .index.minimizers import minimizers
from .options import Options


@dataclass
class Matches:
    """Parallel arrays of exact-match anchors (all length-k)."""
    qpos: np.ndarray   # int64 read positions
    tpos: np.ndarray   # int64 global genome positions
    # per-match genome-minimizer frequency (for anchorfreq statistics)
    freq: np.ndarray

    def __len__(self) -> int:
        return len(self.qpos)


def match_minimizer_lists(
    q_tuples: np.ndarray, q_pos: np.ndarray,
    t_tuples: np.ndarray, t_pos: np.ndarray,
    max_freq: int,
    t_freqs: np.ndarray | None = None,
    q_strand: np.ndarray | None = None,
    t_strand: np.ndarray | None = None,
):
    """Core sorted-list intersection.

    ``t_tuples`` must be sorted ascending.  Returns
    (qpos, tpos, freq, is_rev) with is_rev=None unless both strand arrays
    are given.
    """
    order = np.argsort(q_tuples, kind="stable")
    qt, qp = q_tuples[order], q_pos[order]
    qs = q_strand[order] if q_strand is not None else None

    # read-side tuple run lengths (multiplicity cap)
    if len(qt):
        b = np.concatenate([[True], qt[1:] != qt[:-1]])
        rid = np.cumsum(b) - 1
        qrun = np.bincount(rid)[rid]
    else:
        qrun = np.zeros(0, dtype=np.int64)

    lo = np.searchsorted(t_tuples, qt, side="left")
    hi = np.searchsorted(t_tuples, qt, side="right")
    counts = hi - lo
    emit = (counts > 0) & (qrun <= max_freq)

    qp_e, lo_e, cnt_e = qp[emit], lo[emit], counts[emit]
    qs_e = qs[emit] if qs is not None else None

    total = int(cnt_e.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), z.copy(), None
    # expand: row r of the emit set contributes cnt_e[r] target rows
    rep = np.repeat(np.arange(len(cnt_e)), cnt_e)
    offs = np.arange(total) - np.repeat(np.cumsum(cnt_e) - cnt_e, cnt_e)
    t_rows = lo_e[rep] + offs

    qpos = qp_e[rep].astype(np.int64)
    tpos = t_pos[t_rows].astype(np.int64)
    freq = (t_freqs[t_rows].astype(np.int64)
            if t_freqs is not None else np.ones(total, dtype=np.int64))
    is_rev = None
    if qs_e is not None and t_strand is not None:
        is_rev = (qs_e[rep] != t_strand[t_rows])
    return qpos, tpos, freq, is_rev


def find_matches_batch(reads_codes: list, index: GlobalIndex,
                       opts: Options) -> list:
    """Batched find_matches: one native intersection call for the whole
    read batch (native.match_batch).  Returns [(fwd, rev)] per read with
    the semantics of match_minimizer_lists — the multiplicity cap is per
    read."""
    k, w = index.k, opts.global_w
    per_read = [minimizers(c, k, w, canonical=True,
                           exact=opts.exact_ref_minimizers)
                for c in reads_codes]
    n = len(per_read)
    counts = np.fromiter((len(t) for (t, _, _) in per_read), np.int64, n)
    if counts.sum() == 0:
        z = np.zeros(0, np.int64)
        empty = (Matches(z, z.copy(), z.copy()),
                 Matches(z.copy(), z.copy(), z.copy()))
        return [empty] * n
    qt = np.concatenate([t for (t, _, _) in per_read])
    qp = np.concatenate([p for (_, p, _) in per_read])
    qs = np.concatenate([s for (_, _, s) in per_read])

    # one native pass over the batch (CompareLists analog): per read,
    # stable sort by tuple, multiplicity cap, index lookup and expansion
    read_off = np.concatenate([[0], np.cumsum(counts)])
    # prefix LUT over the sorted index (built once, cached on the index
    # object): on 100Mb+ genomes it replaces log2(ni) cache-missing
    # probes per distinct tuple with ~4 in-bucket ones
    lut = getattr(index, "_match_lut", False)
    if lut is False:
        lut = native.match_lut_build(index.tuples, 2 * k)
        index._match_lut = lut
    qpos, tpos, freq, is_rev, rstart = native.match_batch(
        qt, qp, qs, read_off, index.tuples, index.pos,
        index.strand, index.freqs, opts.global_max_freq, lut=lut)
    out = []
    for r in range(n):
        s, e = int(rstart[r]), int(rstart[r + 1])
        ir = is_rev[s:e]
        out.append((Matches(qpos[s:e][~ir], tpos[s:e][~ir], freq[s:e][~ir]),
                    Matches(qpos[s:e][ir], tpos[s:e][ir], freq[s:e][ir])))
    return out


def find_matches(read_codes: np.ndarray, index: GlobalIndex, opts: Options):
    """Read -> (forward Matches, reverse Matches).

    Equivalent of StoreMinimizers + sort + CompareLists +
    SeparateMatchesByStrand (reference: MapRead.h:169-203).
    Delegates to the batched implementation so the cap/expand semantics
    live in exactly one place.
    """
    return find_matches_batch([read_codes], index, opts)[0]
