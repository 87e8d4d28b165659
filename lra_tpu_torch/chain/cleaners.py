"""Anchor-chain cleaners (reference: Chain.h:547-986).

Chains are stored end-first (descending read coordinate), matching the
reference's traceback order; the cleaners' sign conventions depend on it.

UltimateChain here is a struct-of-arrays: (qpos, tpos, length, strand,
cluster) per anchor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class AnchorChain:
    qpos: np.ndarray     # int64, end-first (descending)
    tpos: np.ndarray     # chrom-local
    length: np.ndarray
    strand: np.ndarray   # uint8 per anchor
    cluster: np.ndarray  # originating extended-cluster index
    second_sdp_value: float = 0.0

    def __len__(self):
        return len(self.qpos)

    def take(self, keep: np.ndarray) -> None:
        self.qpos = self.qpos[keep]
        self.tpos = self.tpos[keep]
        self.length = self.length[keep]
        self.strand = self.strand[keep]
        self.cluster = self.cluster[keep]


def _pair_gaps(q, t, ln, s):
    """Vectorized per-adjacent-pair diagonal gap (reference sign
    conventions, Chain.h:556-575): gap[c-1] for pair (c-1, c); strand
    flips yield gap 0 with same=False."""
    same = s[1:] == s[:-1]
    g0 = (t[1:] - q[1:]) - (t[:-1] - q[:-1])
    g1 = (q[1:] + ln[1:] + t[1:]) - (q[:-1] + ln[:-1] + t[:-1])
    gap = np.where(s[1:] == 0, g0, g1)
    return np.where(same, gap, 0), same


def _sv_entries(q, t, ln, s, lo, hi):
    """The cleaners' shared event list: strand flips enter with value 0,
    same-strand pairs enter when lo < |gap| <= hi.  Returns (sv, pos)."""
    gap, same = _pair_gaps(q, t, ln, s)
    keep = ~same | ((np.abs(gap) > lo) & (np.abs(gap) <= hi))
    pos = np.flatnonzero(keep) + 1
    sv = np.where(same, gap, 0)[pos - 1]
    return sv, pos


def _paired_hits(sv, pos, max_pos_gap):
    """Indices c where entries (c-1, c) are opposite-sign nonzero gaps
    within max_pos_gap anchors."""
    if len(sv) < 2:
        return np.zeros(0, np.int64)
    a, b = sv[:-1], sv[1:]
    cond = (a != 0) & (b != 0) & ((a >= 0) != (b >= 0)) & \
        (pos[1:] - pos[:-1] <= max_pos_gap)
    return np.flatnonzero(cond) + 1


def remove_small_paired_indels(ch: AnchorChain) -> None:
    """reference: Chain.h:547-600 (RemoveSmallPairedIndels)."""
    n = len(ch)
    if n < 2:
        return
    q, t, ln, s = ch.qpos, ch.tpos, ch.length, ch.strand
    sv, pos = _sv_entries(q, t, ln, s, 5, 50)
    remove = np.zeros(n, dtype=bool)
    for c in _paired_hits(sv, pos, 2):
        if abs(int(sv[c - 1]) + int(sv[c])) <= 20:
            span = slice(pos[c - 1], pos[c])
            remove[span] |= ln[span] <= 50
    if remove.any():
        ch.take(~remove)


def remove_paired_indels(ch: AnchorChain, refine_ends: bool = True) -> None:
    """reference: Chain.h:607-750 (RemovePairedIndels): cancel opposite
    >=300b or sum<100 paired gaps; optional end trim via mean+4sd of
    inter-anchor distance."""
    n = len(ch)
    if n < 2:
        return
    q, t, ln, s = ch.qpos, ch.tpos, ch.length, ch.strand
    remove = np.zeros(n, dtype=bool)

    dists = np.zeros(0, np.float64)
    if refine_ends:
        tdist = np.where(t[1:] > t[:-1] + ln[:-1],
                         t[1:] - (t[:-1] + ln[:-1]),
                         t[:-1] - (t[1:] + ln[1:]))
        # reference computes qDist with a t/q typo (Chain.h:633);
        # we use the sane q distance
        qdist = np.where(q[1:] > q[:-1] + ln[:-1],
                         q[1:] - (q[:-1] + ln[:-1]),
                         q[:-1] - (q[1:] + ln[1:]))
        dists = np.minimum(tdist, qdist).astype(np.float64)
        mean = dists.mean()
        sd = np.sqrt(max(0.0, (dists ** 2).mean() - mean ** 2))

    sv, pos = _sv_entries(q, t, ln, s, 30, np.iinfo(np.int64).max)
    for c in _paired_hits(sv, pos, 2):
        a, b = int(sv[c - 1]), int(sv[c])
        if (abs(a) >= 300 and abs(b) >= 300) or abs(a + b) < 100:
            span = slice(pos[c - 1], pos[c])
            remove[span] |= ln[span] < 100

    if refine_ends and len(dists):
        thresh = mean + 4 * sd
        valid = np.nonzero(dists < thresh)[0]
        if len(valid) == 0:
            remove |= ln < 100
        else:
            first_valid = int(valid[0])       # dist index c-1 -> anchors c-1,c
            last_valid = int(valid[-1]) + 1
            if 0 < first_valid < 3:
                for i in range(first_valid):
                    if ln[i] < 100:
                        remove[i] = True
            if n - last_valid < 3 and last_valid + 1 <= n:
                for i in range(last_valid + 1, n):
                    if ln[i] < 100:
                        remove[i] = True
    if remove.any():
        ch.take(~remove)


def clean_spurious_jumping_anchors(ch: AnchorChain) -> None:
    """reference: Chain.h:278-329 (UltimateChain::CleanSpuriousJumpingAnchors).

    Chains are end-first (descending q), so t should descend on strand 0
    and ascend on strand 1.  A run of <=3 anchors that jumps against that
    direction and then returns past the jump origin is removed.  NOTE:
    the reference declares and defines this cleaner but never calls it
    (no call site in the tree); it is provided for API parity and is
    likewise not wired into the pipelines.
    """
    n = len(ch)
    if n < 2:
        return
    t, ln, s = ch.tpos, ch.length, ch.strand
    remove = np.zeros(n, dtype=bool)
    jump = -1
    jump_tpos = 0
    cur = 0
    for im in range(n - 1):
        cur = im + 1
        prev = im
        if jump == -1:
            if s[cur] == s[prev]:
                if s[cur] == 0:
                    if t[cur] + ln[cur] > t[prev]:
                        jump, jump_tpos = cur, int(t[prev])
                else:
                    if t[cur] < t[prev] + ln[prev]:
                        jump, jump_tpos = cur, int(t[prev] + ln[prev])
        else:
            if s[cur] == 0:
                if t[cur] + ln[cur] <= jump_tpos and cur - jump <= 3:
                    remove[jump:cur] = True
                    jump = -1
            else:
                if t[cur] >= jump_tpos and cur - jump <= 3:
                    remove[jump:cur] = True
                    jump = -1
    if jump != -1 and cur - jump <= 3:
        remove[jump:cur + 1] = True
    if remove.any():
        ch.take(~remove)


def remove_spurious_anchors(ch: AnchorChain) -> None:
    """reference: Chain.h:828-895: between two >=500 diagonal jumps within
    10 anchors, drop the short (<50) anchors if none is >=50."""
    n = len(ch)
    if n < 2:
        return
    q, t, ln, s = ch.qpos, ch.tpos, ch.length, ch.strand
    sv, pos = _sv_entries(q, t, ln, s, 499, np.iinfo(np.int64).max)
    remove = np.zeros(n, dtype=bool)
    if len(sv) >= 2:
        cond = (sv[1:] != 0) & (sv[:-1] != 0) & (pos[1:] - pos[:-1] <= 10)
        for c in np.flatnonzero(cond) + 1:
            span = slice(pos[c - 1], pos[c])
            if not (ln[span] >= 50).any():
                remove[span] = True
    if remove.any():
        ch.take(~remove)
