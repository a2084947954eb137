"""Frequency-domain resource allocation math (TS 38.214 §5.1.2.2.2).

Copy of ``srsran_edgeric_5g_tpu/ran/alloc.py`` (plain Python).  Type-1
contiguous allocations are signalled in DCI as a single resource indication
value packing (start, length), the reference's ra_frequency_type1 helpers.
"""

from __future__ import annotations


def riv_encode(n_size: int, start: int, length: int) -> int:
    """(S, L) -> RIV over an n_size-PRB bandwidth part."""
    assert 1 <= length <= n_size - start, (start, length, n_size)
    if (length - 1) <= n_size // 2:
        return n_size * (length - 1) + start
    return n_size * (n_size - length + 1) + (n_size - 1 - start)


def riv_decode(n_size: int, riv: int) -> tuple[int, int]:
    """RIV -> (start, length); inverse of riv_encode."""
    length = riv // n_size + 1
    start = riv % n_size
    if length + start > n_size:
        length = n_size - length + 2
        start = n_size - 1 - start
    assert 1 <= length <= n_size - start, (riv, n_size)
    return start, length
