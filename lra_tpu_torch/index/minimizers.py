"""Minimizer extraction.

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

Both rules run in the native host library (lrn_minimizers_ref /
lrn_minimizers in native/lra_native.cpp).
"""

from __future__ import annotations

import numpy as np

from .. import native


def minimizers(
    codes: np.ndarray, k: int, w: int, canonical: bool = True,
    exact: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract minimizer occurrences from a 2-bit code array.

    Returns (tuples, positions, strands), positions strictly increasing.
    strands is all-zero when canonical=False.  exact=True (default)
    follows the reference's streaming emission semantics; exact=False
    the leftmost windowed-argmin rule (see module docstring).
    """
    if len(codes) < k + w - 1:
        return (np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                np.zeros(0, np.uint8))
    return native.minimizers(codes, k, w, canonical, exact)
