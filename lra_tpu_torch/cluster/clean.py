"""Off-diagonal match cleaning.

Faithful port of the reference's two-pass cleaner
(reference: Clustering.h:566-868 ``CleanOffDiagonal`` and
``SecondRoundCleanOffDiagonal``):

1. mark matches whose diagonal difference to their successor is
   < clean_max_diag; maximal marked runs (plus their terminator) are
   candidate clusters;
2. adaptive minimum run size: min(floor(largest_run/10), min_diag_cluster);
3. per surviving run, anchorfreq = run_len / #distinct read minimizers;
   frequency/length-scaled second clean with bidirectional confirmation.
   The reference's second clean has a cascade (Clustering.h:830-838): once
   a sub-run of the required length is found, every later element in the
   scan direction stays marked — the net effect is trimming the run to
   [first accepted sub-run start, last accepted sub-run end].  Reproduced
   exactly.

Match order contract: matches must be diagonal-sorted (fwd: by q-t then q,
reference Sorting.h:35-48) or anti-diagonal-sorted (rev: by q+t then q,
Sorting.h:76-93) before calling.
"""

from __future__ import annotations

import math

import numpy as np

from ..options import Options
from .types import Cluster


def diagonal_sort(qpos, tpos, strand: int):
    """Return the order that diagonal-sorts matches (reference
    DiagonalSort/AntiDiagonalSort)."""
    if strand == 0:
        return np.lexsort((qpos, qpos - tpos))
    return np.lexsort((qpos, qpos + tpos))


def _diag(qpos, tpos, strand: int):
    return (tpos - qpos) if strand == 0 else (qpos + tpos)


def _runs_from_marks(on: np.ndarray):
    """Maximal True-runs [s, e] inclusive of the False terminator e
    (reference's [diagStart, i] convention)."""
    runs = []
    n = len(on)
    i = 0
    start = -1
    prev = False
    for i in range(n):
        if not prev and on[i]:
            start = i
        if prev and not on[i]:
            runs.append((start, i))
        prev = on[i]
    # first-pass marking guarantees on[-1] is False, so no trailing run
    return runs


def _second_round(qpos, tpos, strand, os_, oe, min_diag_cluster,
                  clean_max_diag):
    """reference: Clustering.h:802-868.  Returns bool mask over [os_, oe)."""
    n = oe - os_
    if min_diag_cluster >= n:
        return np.zeros(n, dtype=bool), False   # (mask, keep_everything)
    if min_diag_cluster <= 0:
        return np.ones(n, dtype=bool), True
    if n <= 1:
        return np.zeros(n, dtype=bool), False

    d = _diag(qpos[os_:oe], tpos[os_:oe], strand)
    close = np.abs(np.diff(d)) < clean_max_diag   # pair (i, i+1)

    # forward: find first sub-run [ds, e] (run of close-pairs + terminator)
    # with length >= min_diag_cluster; everything from ds on is kept.
    fwd = np.zeros(n, dtype=bool)
    i = 0
    while i < n - 1:
        if close[i]:
            ds = i
            while i < n - 1 and close[i]:
                i += 1
            # run [ds, i] inclusive terminator
            if i - ds + 1 >= min_diag_cluster:
                fwd[ds:] = True
                break
        else:
            i += 1
    # reverse symmetric
    rev = np.zeros(n, dtype=bool)
    i = n - 1
    while i > 0:
        if close[i - 1]:
            de = i
            while i > 0 and close[i - 1]:
                i -= 1
            if de - i + 1 >= min_diag_cluster:
                rev[:de + 1] = True
                break
        else:
            i -= 1
    mask = fwd & rev
    return mask, bool(mask.any())


def clean_off_diagonal(qpos, tpos, opts: Options, strand: int = 0,
                       diag_origin: int = -1, diag_drift: int = -1):
    """Returns (keep_indices, run_id, run_freq) into the input arrays.

    run_id groups surviving matches into diagonal runs (the reference's
    ``count``); run_freq is the run's anchorfreq.
    """
    n = len(qpos)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))
    if n == 0:
        return empty

    d = _diag(qpos, tpos, strand)
    on = np.zeros(n, dtype=bool)
    close = np.abs(np.diff(d)) < opts.clean_max_diag
    if diag_origin != -1:
        drift_ok = np.abs(d - diag_origin) < diag_drift
        # pair (i-1, i) marks on[i-1], gated on drift of match i
        # (reference: Clustering.h:578-583)
        on[:-1] = close & drift_ok[1:]
        # plus the initial mark on match 0, gated on drift of match 0
        # (reference: Clustering.h:572-576)
        if n > 1 and close[0] and drift_ok[0]:
            on[0] = True
    else:
        on[:-1] = close

    runs = _runs_from_marks(on)
    if not runs:
        return empty
    largest = max(e - s + 1 for s, e in runs)
    min_diag_cluster = min(largest // 10, opts.min_diag_cluster)

    keep = []
    run_id = []
    run_freq = []
    counter = 0
    for s, e in runs:   # e inclusive
        ln = e - s + 1
        if ln < min_diag_cluster:
            counter += 1
            continue
        avgfreq = ln / len(np.unique(qpos[s:e + 1]))
        accept_all = False
        second = None
        if opts.bypass_clustering:
            if avgfreq >= 3.0 and ln < 10:
                pass  # drop
            elif avgfreq >= 2.0 and ln >= opts.clean_cluster_size:
                mdc = (opts.second_clean_min_diag_cluster
                       + math.floor((avgfreq - 1.5) / 1.0) * opts.punish_anchorfreq
                       + ((ln - opts.clean_cluster_size) // opts.clean_cluster_size)
                       * opts.anchor_per_length)
                second = mdc
            elif avgfreq >= 1.5 and ln >= opts.clean_cluster_size:
                mdc = (opts.second_clean_min_diag_cluster
                       + math.floor((avgfreq - 1.5) / 1.5) * opts.punish_anchorfreq
                       + ((ln - opts.clean_cluster_size) // opts.clean_cluster_size)
                       * opts.anchor_per_length)
                second = mdc
            else:
                accept_all = True
        else:
            if avgfreq >= 3.0 and ln < 10:
                pass
            elif avgfreq >= 4.0 and ln >= opts.clean_cluster_size:
                second = (opts.second_clean_min_diag_cluster
                          + math.floor((avgfreq - 1.5) / 1.0) * opts.punish_anchorfreq
                          + ((ln - opts.clean_cluster_size) // opts.clean_cluster_size)
                          * opts.anchor_per_length)
            elif avgfreq >= 1.5 and ln >= opts.clean_cluster_size:
                second = (opts.second_clean_min_diag_cluster
                          + math.floor((avgfreq - 1.5) / 1.5) * opts.punish_anchorfreq
                          + ((ln - opts.clean_cluster_size) // opts.clean_cluster_size)
                          * opts.anchor_per_length)
            elif avgfreq > 1.0 and ln >= opts.clean_cluster_size:
                second = (opts.second_clean_min_diag_cluster
                          - (5 - math.floor((avgfreq - 1.0) / 0.1))
                          * (opts.punish_anchorfreq // 2)
                          + ((ln - opts.clean_cluster_size) // opts.clean_cluster_size)
                          * (opts.anchor_per_length // 2))
            elif avgfreq > 1.0:
                second = (opts.second_clean_min_diag_cluster
                          - (5 - math.floor((avgfreq - 1.0) / 0.1))
                          * (opts.punish_anchorfreq // 2)
                          - ((opts.clean_cluster_size - ln) // 15)
                          * (opts.anchor_per_length // 2))
            else:
                accept_all = True

        if accept_all:
            idx = np.arange(s, e + 1)
        elif second is not None:
            mask, any_kept = _second_round(
                qpos, tpos, strand, s, e + 1, second,
                opts.second_clean_max_diag)
            idx = np.arange(s, e + 1)[mask]
        else:
            idx = np.zeros(0, dtype=np.int64)

        if len(idx):
            keep.append(idx)
            run_id.append(np.full(len(idx), counter))
            run_freq.append(np.full(len(idx), avgfreq))
        counter += 1

    if not keep:
        return empty
    return (np.concatenate(keep).astype(np.int64),
            np.concatenate(run_id).astype(np.int64),
            np.concatenate(run_freq))


def runs_to_clusters(qpos, tpos, keep, run_id, run_freq, k, strand,
                     genome) -> list:
    """ExtractDiagonalFromClean: each surviving run becomes a cluster
    (reference: Clustering.h:733-800); clusters always carry their match
    arrays here (cheap numpy slices)."""
    clusters = []
    if len(keep) == 0:
        return clusters
    qk, tk = qpos[keep], tpos[keep]
    boundaries = np.concatenate([[True], run_id[1:] != run_id[:-1]])
    starts = np.nonzero(boundaries)[0]
    ends = np.concatenate([starts[1:], [len(keep)]])
    for s, e in zip(starts, ends):
        c = Cluster(qk[s:e].copy(), tk[s:e].copy(), strand, k,
                    anchorfreq=float(run_freq[s]))
        c.set_boundaries()
        c.chrom = int(genome.chrom_of(c.tStart))
        clusters.append(c)
    return clusters
