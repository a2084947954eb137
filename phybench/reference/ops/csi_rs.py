"""NZP-CSI-RS and SRS sequences as host constants: CSI-RS Gold QPSK pilots
(TS 38.211 §7.4.1.5) and the SRS low-PAPR sequence on its comb
(§6.4.1.4), from which the full cell builds its slot rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .low_papr import base_sequence
from .sequences import np_gold_sequence

SQRT1_2 = np.float32(1.0 / np.sqrt(2.0))


def csi_rs_c_init(slot: int, symbol: int, scrambling_id: int) -> int:
    """TS 38.211 §7.4.1.5.2."""
    return ((1 << 10) * (14 * slot + symbol + 1) * (2 * scrambling_id + 1)
            + scrambling_id) % (1 << 31)


@dataclasses.dataclass(frozen=True)
class CsiRsConfig:
    scrambling_id: int
    slot: int
    symbol: int
    start_prb: int
    nof_prb: int
    density: int = 1        # REs per PRB (1 or 3)
    comb_offset: int = 0    # k0 within the PRB


def csi_rs_pilots(cfg: CsiRsConfig) -> np.ndarray:
    """(npilots,) complex64 QPSK pilots of the configured symbol."""
    npil = cfg.density * (cfg.start_prb + cfg.nof_prb)
    c = np_gold_sequence(csi_rs_c_init(cfg.slot, cfg.symbol, cfg.scrambling_id),
                         2 * npil)
    r = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) * SQRT1_2
    return r[cfg.density * cfg.start_prb:].astype(np.complex64)


def csi_rs_subcarriers(cfg: CsiRsConfig) -> np.ndarray:
    """Absolute subcarrier indices of the CSI-RS REs."""
    if cfg.density == 1:
        k = 12 * (cfg.start_prb + np.arange(cfg.nof_prb)) + cfg.comb_offset
    elif cfg.density == 3:
        base = 12 * (cfg.start_prb + np.arange(cfg.nof_prb))[:, None]
        k = (base + cfg.comb_offset + 4 * np.arange(3)[None, :]).reshape(-1)
    else:
        raise ValueError(f"density {cfg.density}")
    return k.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SrsConfig:
    sequence_id: int
    slot: int
    symbol: int
    start_prb: int
    nof_prb: int            # sounded bandwidth
    comb: int = 2           # KTC: 2 or 4
    comb_offset: int = 0
    cyclic_shift: int = 0   # n_cs in [0, 8/12)

    @property
    def m_sc(self) -> int:
        return self.nof_prb * 12 // self.comb


def srs_sequence(cfg: SrsConfig) -> np.ndarray:
    """r(n): low-PAPR base sequence with the SRS cyclic shift (§6.4.1.4.2)."""
    n_cs_max = 8 if cfg.comb == 2 else 12
    alpha = 2.0 * np.pi * cfg.cyclic_shift / n_cs_max
    base = base_sequence(cfg.sequence_id % 30, 0, cfg.m_sc)
    n = np.arange(cfg.m_sc)
    return (np.exp(1j * alpha * n) * base).astype(np.complex64)


def srs_subcarriers(cfg: SrsConfig) -> np.ndarray:
    k0 = 12 * cfg.start_prb + cfg.comb_offset
    return (k0 + cfg.comb * np.arange(cfg.m_sc)).astype(np.int32)

