"""Shared small utilities."""


def pow2_at_least(n: int, lo: int = 1) -> int:
    """Smallest power-of-two multiple of ``lo`` that is >= n."""
    b = lo
    while b < n:
        b *= 2
    return b
