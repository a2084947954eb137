"""PSS / SSS sequences (TS 38.211 §7.4.2).

Port of ``srsran_edgeric_5g_tpu/ops/sync_signals.py``: tiny static
m-sequences built on the host, their placement in an SSB grid, and the
cell-search PSS correlation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

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


def map_ssb_sync(grid: torch.Tensor, pci: int, first_symbol: int = 0,
                 first_subcarrier: int = 0, amplitude: float = 1.0) -> torch.Tensor:
    """Place PSS (symbol 0) and SSS (symbol 2) into a (..., nsymb, nsubc)
    grid, returning a new grid.  PSS/SSS sit on subcarriers 56..182 of the
    240-subcarrier block (TS 38.211 Table 7.4.3.1-1)."""
    n_id1, n_id2 = pci_to_nid(pci)
    sl = torch.arange(PSS_LEN, device=grid.device) + first_subcarrier + 56
    out = grid.clone()
    out[..., first_symbol, sl] = torch.as_tensor(
        pss_sequence(n_id2) * np.float32(amplitude), device=grid.device).to(grid.dtype)
    out[..., first_symbol + 2, sl] = torch.as_tensor(
        sss_sequence(n_id1, n_id2) * np.float32(amplitude),
        device=grid.device).to(grid.dtype)
    return out


def pss_correlate(rx_symbols: torch.Tensor) -> torch.Tensor:
    """Correlate (..., 127) frequency-domain REs against the 3 PSS sequences
    -> (..., 3) correlation magnitudes (the cell-search N_ID2 metric)."""
    seqs = torch.as_tensor(np.stack([pss_sequence(i) for i in range(3)]),
                           device=rx_symbols.device).to(torch.complex64)
    return torch.einsum("...n,kn->...k", rx_symbols.to(torch.complex64), seqs).abs()
