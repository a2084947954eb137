"""PSS / SSS sequences (TS 38.211 §7.4.2): tiny static m-sequences built on
the host.
"""
from __future__ import annotations

import functools

import numpy as np

SSB_NSYMB = 4
SSB_NSUBC = 240
PSS_LEN = 127


def _lfsr127(taps: tuple[int, ...], init: tuple[int, ...]) -> np.ndarray:
    x = np.zeros(127 + 7, dtype=np.int8)
    x[:7] = init
    for i in range(127):
        x[i + 7] = sum(x[i + t] for t in taps) % 2
    return x[:127]


@functools.lru_cache(maxsize=None)
def _pss_base() -> np.ndarray:
    # x(i+7) = x(i+4) + x(i); [x(6)..x(0)] = 1110110 (§7.4.2.2.1).
    return _lfsr127((0, 4), (0, 1, 1, 0, 1, 1, 1))


@functools.lru_cache(maxsize=None)
def _sss_bases() -> tuple[np.ndarray, np.ndarray]:
    # x0(i+7) = x0(i+4) + x0(i); x1(i+7) = x1(i+1) + x1(i); both initialised
    # [x(6)..x(0)] = 0000001 (§7.4.2.3.1).
    return (_lfsr127((0, 4), (1, 0, 0, 0, 0, 0, 0)),
            _lfsr127((0, 1), (1, 0, 0, 0, 0, 0, 0)))


def pss_sequence(n_id2: int) -> np.ndarray:
    """d_PSS(n) = 1 - 2 x((n + 43 N_ID2) mod 127), float32 (127,)."""
    m = (np.arange(PSS_LEN) + 43 * n_id2) % 127
    return (1 - 2 * _pss_base()[m]).astype(np.float32)


def sss_sequence(n_id1: int, n_id2: int) -> np.ndarray:
    """d_SSS(n) per §7.4.2.3, float32 (127,)."""
    x0, x1 = _sss_bases()
    m0 = 15 * (n_id1 // 112) + 5 * n_id2
    m1 = n_id1 % 112
    n = np.arange(PSS_LEN)
    return ((1 - 2 * x0[(n + m0) % 127]) * (1 - 2 * x1[(n + m1) % 127])
            ).astype(np.float32)


def pci_to_nid(pci: int) -> tuple[int, int]:
    """Physical cell id N_ID^cell = 3 N_ID1 + N_ID2."""
    return pci // 3, pci % 3

