"""2-bit sequence encoding and reverse complement.

Vectorized (numpy) equivalent of the reference's per-character tables
(reference: SeqUtils.h:7-158).  A=0 C=1 G=2 T=3, anything else = 4 ("N").
The whole framework operates on uint8 code arrays; ASCII only exists at the
I/O boundary.
"""

from __future__ import annotations

import numpy as np

# ASCII -> 2-bit code, case-insensitive; invalid -> 4 (reference: SeqUtils.h seqMapN).
_CODE_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _CODE_TABLE[ord(_c)] = _i
    _CODE_TABLE[ord(_c.lower())] = _i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes (0..3, 4 for N/invalid)."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return _CODE_TABLE[arr]


def decode(codes: np.ndarray) -> str:
    return _DECODE[codes].tobytes().decode()


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array; N (4) maps to N.

    Reference: SeqUtils.h CreateRC.
    """
    comp = np.where(codes < 4, 3 - codes, codes).astype(np.uint8)
    return comp[::-1].copy()
