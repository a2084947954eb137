"""PUCCH tables (TS 38.211 §6.3.2, §6.4.1.3): the configurations, the
cyclic-shift hopping table n_cs(ns, l), the format 0/1 sequences, the
format 1 OCC and the format 2 data and DM-RS subcarriers, from which the
full cell builds its batched F1 / F2 rows.  Group hopping is 'neither':
u = n_ID mod 30, v = 0.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .low_papr import base_sequence
from .sequences import np_gold_sequence

NSC = 12


@dataclasses.dataclass(frozen=True)
class Pucch01Config:
    n_id: int          # hopping id (cell id by default)
    slot: int
    start_symbol: int
    nof_symbols: int   # 1-2 (F0), 4-14 (F1)
    initial_cs: int
    prb: int = 0       # PRB offset of the single-PRB allocation

    @property
    def u(self) -> int:
        return self.n_id % 30


@functools.lru_cache(maxsize=None)
def _ncs_table(n_id: int, slot: int) -> np.ndarray:
    """n_cs(ns, l) for all 14 symbols (TS 38.211 §6.3.2.2.2)."""
    c = np_gold_sequence(n_id, 8 * 14 * (slot + 1))
    base = 8 * 14 * slot
    out = np.zeros(14, dtype=np.int64)
    for l in range(14):
        bits = c[base + 8 * l: base + 8 * l + 8]
        out[l] = int((bits * (1 << np.arange(8))).sum())
    return out


def _f0_sequence(cfg: Pucch01Config, m0: int, symbol: int) -> np.ndarray:
    ncs = _ncs_table(cfg.n_id, cfg.slot)[symbol]
    alpha = 2.0 * np.pi / NSC * ((m0 + ncs) % NSC)
    base = base_sequence(cfg.u, 0, NSC)
    n = np.arange(NSC)
    return (np.exp(1j * alpha * n) * base).astype(np.complex64)


def _occ(n: int, i: int) -> np.ndarray:
    """F1 time-domain OCC w_i(m) = e^{j 2 pi i m / N_SF} (Table
    6.3.2.4.1-2)."""
    k = np.arange(n)
    return np.exp(2j * np.pi * i * k / n).astype(np.complex64)


@dataclasses.dataclass(frozen=True)
class Pucch2Config:
    rnti: int
    n_id: int          # scrambling id
    n_id0: int         # DM-RS scrambling id
    slot: int
    start_symbol: int
    nof_symbols: int   # 1-2
    start_prb: int
    nof_prb: int
    uci_bits: int

    @property
    def data_sc_per_prb(self) -> int:
        return 8  # 12 minus 4 DM-RS (subcarriers 3k+1)

    @property
    def e_total(self) -> int:
        return 2 * self.data_sc_per_prb * self.nof_prb * self.nof_symbols


def _f2_data_sc(nof_prb: int) -> np.ndarray:
    """Data subcarriers within the allocation (all except 3k+1)."""
    sc = np.arange(NSC * nof_prb)
    return sc[sc % 3 != 1]


def _f2_dmrs_sc(nof_prb: int) -> np.ndarray:
    sc = np.arange(NSC * nof_prb)
    return sc[sc % 3 == 1]


def _f2_dmrs_cinit(cfg: Pucch2Config, symbol: int) -> int:
    return ((1 << 17) * (14 * cfg.slot + symbol + 1) * (2 * cfg.n_id0 + 1)
            + 2 * cfg.n_id0) % (1 << 31)

