"""NZP-CSI-RS and SRS sequence generation, mapping and LS snapshots.

Port of ``srsran_edgeric_5g_tpu/ops/csi_rs.py``: CSI-RS Gold QPSK pilots
(TS 38.211 §7.4.1.5) and the SRS low-PAPR sequence on its comb (§6.4.1.4)
as host constants, their mapping into a grid, and the receive-side LS
channel snapshots (with the SRS wideband SNR).  The full cell builds its
batched slot rows from the same constants.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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


def _on(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a, device=device)


def map_csi_rs(grid: torch.Tensor, cfg: CsiRsConfig,
               amplitude: float = 1.0) -> torch.Tensor:
    """Write the CSI-RS pilots into a (..., nsymb, nsubc) grid (a new one)."""
    out = grid.clone()
    out[..., cfg.symbol, _on(csi_rs_subcarriers(cfg).astype(np.int64), grid.device)] = \
        _on(csi_rs_pilots(cfg), grid.device) * float(np.float32(amplitude))
    return out


def csi_rs_estimate(rx_grid: torch.Tensor, cfg: CsiRsConfig) -> torch.Tensor:
    """LS channel snapshot at the CSI-RS REs: (..., npilots)."""
    dev = rx_grid.device
    rx = rx_grid[..., cfg.symbol, _on(csi_rs_subcarriers(cfg).astype(np.int64), dev)]
    return rx * _on(csi_rs_pilots(cfg), dev).conj()


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


def map_srs(grid: torch.Tensor, cfg: SrsConfig,
            amplitude: float = 1.0) -> torch.Tensor:
    """Write the SRS sequence onto its comb of a (..., nsymb, nsubc) grid (a
    new one)."""
    out = grid.clone()
    out[..., cfg.symbol, _on(srs_subcarriers(cfg).astype(np.int64), grid.device)] = \
        _on(srs_sequence(cfg), grid.device) * float(np.float32(amplitude))
    return out


def srs_estimate(rx_grid: torch.Tensor, cfg: SrsConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """LS estimate at the sounded comb and the wideband SNR in dB, the noise
    from half the difference of adjacent comb estimates."""
    dev = rx_grid.device
    rx = rx_grid[..., cfg.symbol, _on(srs_subcarriers(cfg).astype(np.int64), dev)]
    h = rx * _on(srs_sequence(cfg), dev).conj()
    d = h[..., 1::2] - h[..., 0::2]
    noise = torch.mean(d.abs() ** 2, dim=-1) / 2.0
    sig = torch.mean(h.abs() ** 2, dim=-1)
    snr_db = 10.0 * torch.log10(torch.clamp(sig, min=1e-30)
                                / torch.clamp(noise, min=1e-30))
    return h, snr_db
