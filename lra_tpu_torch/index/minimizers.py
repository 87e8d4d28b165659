"""Vectorized minimizer extraction.

Semantics follow the reference's streaming state machine
(reference: MinCount.h:8-179 ``StoreMinimizers`` and
MinCount.h:182-338 ``StoreMinimizers_noncanonical``):

* k-mers packed 2 bits/base, first base in the highest bits
  (reference: TupleOps.h:104-112 ``StoreTuple``).
* canonical mode takes min(fwd, revcomp) per position; the chosen strand is
  recorded (the reference packs it into the tuple MSB via ``rev_mask_s``,
  lra.cpp:1008-1027 — we keep a separate strand array, which is equivalent
  because all tuple comparisons mask that bit out).
* windowed minimum over ``w`` consecutive k-mer positions; one minimizer
  occurrence is emitted per distinct (tuple, pos) across sliding windows.
* windows overlapping an N produce nothing (reference: MinCount.h:21-41,
  106-131 valid-window scan).

Emission semantics (exact=True, the default) reproduce the reference's
streaming state machine bit-for-bit (MinCount.h:8-179):

* emission is change-driven — one occurrence per change of the *active*
  minimizer, where sliding keeps the older occurrence on ties
  (MinCount.h:91,164) and expiry recomputes through a circular buffer
  scanned from slot 0 with strict less (MinCount.h:148-154), so ties go
  to the smallest position mod w.  In a run of equal tuples
  (homopolymers, satellite repeats) this emits ~1 occurrence per w
  positions — NOT one per window.
* the first window's comparison is unmasked (MinCount.h:91), so
  reverse-strand canonical k-mers carry the strand MSB and lose to any
  forward-strand k-mer in window 0.
* windows overlapping an N emit nothing, via the reference's tracked
  valid-span pointer (MinCount.h:21-41, 106-131), including its edge
  quirks (a window placement flush with the sequence end is never found
  by the re-search; a failed re-search stops extraction).

exact=False keeps the older self-consistent *leftmost* tie-break rule
(one occurrence per distinct windowed-argmin), selectable via
Options.exact_ref_minimizers.

The exact extractor is an event chain over precomputed k-mer arrays:
between active-minimizer changes nothing is emitted, so only O(n/w)
events are visited, each a small vectorized slice scan.  The leftmost
path is pure array code.  Both have native C++ twins
(lrn_minimizers_ref / lrn_minimizers) with bit-identical output.
"""

from __future__ import annotations

import numpy as np

_STRAND_BIT = np.uint64(1) << np.uint64(63)


def kmer_codes(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack all k-mers of a 2-bit code array.

    Returns (fwd, rc, valid): fwd[i]/rc[i] are the forward and
    reverse-complement packings of codes[i:i+k]; valid[i] is False if the
    window contains an N.
    """
    n = len(codes) - k + 1
    if n <= 0:
        e = np.zeros(0, dtype=np.uint64)
        return e, e.copy(), np.zeros(0, dtype=bool)
    base = codes.astype(np.uint64)
    safe = base & np.uint64(3)
    comp = np.uint64(3) - safe
    fwd = np.zeros(n, dtype=np.uint64)
    rc = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        fwd += safe[j:j + n] << np.uint64(2 * (k - 1 - j))
        rc += comp[j:j + n] << np.uint64(2 * j)
    bad = (codes > 3).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    return fwd, rc, valid


def _sliding_min(vals: np.ndarray, w: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed minimum with leftmost tie-break via doubling sparse table.

    Returns (minval, argpos) for each of the len(vals)-w+1 windows.
    O(L log w) work, fully vectorized.
    """
    n = len(vals)
    pos = np.arange(n, dtype=np.int64)
    v, p = vals.copy(), pos
    span = 1
    while span * 2 <= w:
        m = len(v) - span
        left_v, right_v = v[:m], v[span:]
        left_p, right_p = p[:m], p[span:]
        take_left = left_v <= right_v
        v = np.where(take_left, left_v, right_v)
        p = np.where(take_left, left_p, right_p)
        span *= 2
    # combine two (possibly overlapping) spans covering the window
    m = n - w + 1
    off = w - span
    lv, rv = v[:m], v[off:off + m]
    lp, rp = p[:m], p[off:off + m]
    take_left = lv <= rv
    return np.where(take_left, lv, rv), np.where(take_left, lp, rp)


def _gate_windows(codes: np.ndarray, k: int, w: int, nk: int) -> np.ndarray:
    """Boolean gate per k-mer-window end p: may the window ending at p
    emit?  Emulates the reference's tracked valid-span pointer
    (MinCount.h:21-41,106-131): gate requires the window's base span
    N-free AND the tracker still alive — its re-search scans starts in
    [from, len-span) only, so a clean placement flush with the sequence
    end is reachable only by pointer increments, and a failed re-search
    kills everything after it."""
    L = len(codes)
    span = w + k - 1
    gate = np.zeros(nk, dtype=bool)
    badpos = np.flatnonzero(codes > 3)
    from_base = 0
    while True:
        # earliest N-free span-start s in [from_base, L - span)
        i = int(np.searchsorted(badpos, from_base))
        s = from_base
        found = False
        while s < L - span:
            nb = int(badpos[i]) if i < len(badpos) else L
            if nb >= s + span:
                found = True
                break
            s = nb + 1
            i += 1
        if not found:
            return gate
        # tracker end advances one clean base at a time from s+span; the
        # first N at or past it stops this stretch
        j = int(np.searchsorted(badpos, s + span))
        nb = int(badpos[j]) if j < len(badpos) else L
        p_first = s + w - 1
        p_last = min(nb - k, nk - 1)
        if p_last >= p_first:
            gate[p_first:p_last + 1] = True
        if nb >= L:
            return gate
        from_base = nb + 1


def _minimizers_exact_np(codes: np.ndarray, k: int, w: int,
                         canonical: bool):
    """Pure-numpy twin of lrn_minimizers_ref (exact reference streaming
    semantics).  Event-chain formulation: the active minimizer changes
    only at strict-less slides or expiry recomputes, so we jump from
    event to event (O(n/w) iterations of small slice scans) instead of
    walking every position."""
    empty = (np.zeros(0, np.uint64), np.zeros(0, np.uint32),
             np.zeros(0, np.uint8))
    L = len(codes)
    span = w + k - 1
    if L < k or L < span:
        return empty
    fwd, rc, _ = kmer_codes(codes, k)
    nk = len(fwd)
    if canonical:
        use_rc = rc < fwd
        mv = np.where(use_rc, rc, fwd)
        strand = use_rc.astype(np.uint8)
    else:
        mv = fwd
        strand = np.zeros(nk, dtype=np.uint8)
    gate = _gate_windows(codes, k, w, nk)
    if not gate.any():
        return empty

    # first window [0, w): leftmost strict-min by UNMASKED value — the
    # reference's window-0 comparison includes the strand MSB
    init_keys = mv[:w] | (strand[:w].astype(np.uint64) << np.uint64(63))
    a = int(np.argmin(init_keys))  # argmin returns the first minimum
    out_t, out_p, out_s = [], [], []
    if gate[w - 1]:
        out_t.append(mv[a]); out_p.append(a); out_s.append(strand[a])

    lo = w  # first unexamined slide position
    residues = np.arange(nk, dtype=np.int64) % w
    while True:
        hi = min(a + w, nk)
        hit = np.flatnonzero(mv[lo:hi] < mv[a]) if lo < hi else ()
        if len(hit):
            # strict-less slide: the new k-mer beats the active
            a = lo + int(hit[0])
            p_evt = a
        else:
            # active expires at window end a + w: recompute over the
            # circular buffer — ties to the smallest position mod w
            p_evt = a + w
            if p_evt >= nk:
                break
            win = slice(p_evt - w + 1, p_evt + 1)
            vals = mv[win]
            tied = np.flatnonzero(vals == vals.min())
            r = residues[win][tied]
            a = p_evt - w + 1 + int(tied[np.argmin(r)])
        if gate[p_evt]:
            out_t.append(mv[a]); out_p.append(a); out_s.append(strand[a])
        lo = p_evt + 1
    if not out_t:
        return empty
    return (np.array(out_t, np.uint64), np.array(out_p, np.uint32),
            np.array(out_s, np.uint8))


def minimizers(
    codes: np.ndarray, k: int, w: int, canonical: bool = True,
    exact: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract minimizer occurrences from a 2-bit code array.

    Returns (tuples, positions, strands), positions strictly increasing.
    strands is all-zero when canonical=False.  Uses the native C++
    extractor when built (identical output; see native/lra_native.cpp).
    exact=True (default) follows the reference's streaming emission
    semantics; exact=False the leftmost windowed-argmin rule (see module
    docstring).
    """
    empty = (np.zeros(0, np.uint64), np.zeros(0, np.uint32), np.zeros(0, np.uint8))
    if len(codes) < k + w - 1:
        return empty
    from .. import native
    res = (native.minimizers(codes, k, w, canonical, exact)
           if native.available() else None)
    if res is not None:
        return res
    if exact:
        return _minimizers_exact_np(codes, k, w, canonical)
    fwd, rc, valid = kmer_codes(codes, k)
    if canonical:
        use_rc = rc < fwd  # ties -> forward (k odd => no self-RC ties)
        canon = np.where(use_rc, rc, fwd)
        strand = use_rc.astype(np.uint8)
    else:
        canon = fwd
        strand = np.zeros(len(fwd), dtype=np.uint8)

    # Mask invalid k-mers so they never win a window minimum; windows touching
    # them are dropped anyway.
    canon_m = np.where(valid, canon, np.uint64(0xFFFFFFFFFFFFFFFF))
    _, argpos = _sliding_min(canon_m, w)

    # window j covers k-mers [j, j+w); valid iff all its k-mers are valid
    vcs = np.concatenate([[0], np.cumsum(valid.astype(np.int32))])
    win_valid = (vcs[w:] - vcs[:-w]) == w

    # one occurrence per distinct argmin position among valid windows
    argpos = argpos[win_valid]
    if len(argpos) == 0:
        return empty
    keep = np.empty(len(argpos), dtype=bool)
    keep[0] = True
    np.not_equal(argpos[1:], argpos[:-1], out=keep[1:])
    occ = argpos[keep]
    return canon[occ], occ.astype(np.uint32), strand[occ]
