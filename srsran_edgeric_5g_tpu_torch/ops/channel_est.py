"""Port channel estimation from DM-RS pilots (PUSCH/PDSCH receive side).

Port of ``estimate_port`` and its helpers in
``srsran_edgeric_5g_tpu/ops/channel_est.py``:

  * LS at pilots: H_ls = Y * conj(P)  (unit-modulus QPSK pilots).
  * CFO from the phase of the correlation between the first and last DM-RS
    symbols, compensated before time averaging (>= 2 DM-RS symbols).
  * Noise variance from the time residual across DM-RS symbols (2+
    symbols) or the adjacent-pilot difference (one symbol).
  * Linear frequency interpolation/extrapolation to every subcarrier.

The TA-compensated estimator (``estimate_port_ta``, ``delay_spread_us > 0``)
is not ported yet.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _interp_weights(pilot_pos: tuple, nsubc: int) -> tuple[np.ndarray, np.ndarray]:
    """Static linear interp: target k -> (left pilot index, frac)."""
    pos = np.asarray(pilot_pos, dtype=np.float64)
    k = np.arange(nsubc, dtype=np.float64)
    right = np.searchsorted(pos, k, side="left")
    left = np.clip(right - 1, 0, len(pos) - 2)
    frac = (k - pos[left]) / (pos[left + 1] - pos[left])  # <0 / >1 extrapolate
    return left.astype(np.int64), frac.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _interp_on(pilot_pos: tuple, nsubc: int, device: torch.device):
    left, frac = _interp_weights(pilot_pos, nsubc)
    return (torch.as_tensor(left, device=device),
            torch.as_tensor(left + 1, device=device),
            torch.as_tensor(frac, device=device))


def ls_estimate(rx_pilots: torch.Tensor, ref_pilots: torch.Tensor) -> torch.Tensor:
    """Least-squares estimate at pilot positions: Y * conj(P) (|P| = 1)."""
    return rx_pilots * torch.conj(ref_pilots)


def cfo_correlation(h_ls: torch.Tensor) -> torch.Tensor:
    """Complex first-to-last DM-RS pilot correlation sum h[-1]*conj(h[0])."""
    return torch.sum(h_ls[..., -1, :] * torch.conj(h_ls[..., 0, :]), dim=-1)


def cfo_estimate(h_ls: torch.Tensor, symbol_distance_s: float) -> torch.Tensor:
    """CFO (Hz) from the phase drift between the first and last DM-RS
    symbols; ``h_ls``: (..., ndmrs, npilots) with ndmrs >= 2."""
    corr = cfo_correlation(h_ls)
    return torch.angle(corr) / (2.0 * math.pi * symbol_distance_s)


def estimate_port(rx_pilots: torch.Tensor, ref_pilots: torch.Tensor,
                  pilot_subcarriers: np.ndarray, nsubc: int,
                  dmrs_symbol_times_s: np.ndarray | None = None,
                  compensate_cfo: bool = True,
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Estimate one port's channel over the whole band.

    Args:
      rx_pilots: (..., ndmrs, npilots) received DM-RS REs.
      ref_pilots: (..., ndmrs, npilots) or (..., npilots) transmitted pilots.
      pilot_subcarriers: static (npilots,) positions within [0, nsubc).
      nsubc: band width in subcarriers.
      dmrs_symbol_times_s: static (ndmrs,) symbol start times (CFO needs >= 2).

    Returns (h_freq (..., nsubc) complex64, noise_var (...,), cfo_hz (...,)).
    """
    if ref_pilots.ndim < rx_pilots.ndim:
        ref_pilots = ref_pilots[..., None, :]
    h_ls = ls_estimate(rx_pilots, ref_pilots)          # (..., ndmrs, npilots)
    ndmrs = h_ls.shape[-2]

    cfo = torch.zeros(h_ls.shape[:-2], dtype=torch.float32, device=h_ls.device)
    if ndmrs >= 2 and dmrs_symbol_times_s is not None:
        dt = float(dmrs_symbol_times_s[-1] - dmrs_symbol_times_s[0])
        cfo = cfo_estimate(h_ls, dt)
        if compensate_cfo:
            t = torch.as_tensor(np.asarray(dmrs_symbol_times_s, dtype=np.float32),
                                device=h_ls.device)
            ph = (-2.0 * math.pi) * cfo[..., None] * t   # float32, as the reference
            h_ls = h_ls * torch.polar(torch.ones_like(ph), ph)[..., None]

    h_p = torch.mean(h_ls, dim=-2)                     # (..., npilots)

    if ndmrs >= 2:
        resid = h_ls - h_p[..., None, :]
        # E|resid|^2 = sigma^2 * (ndmrs-1)/ndmrs per element.
        noise_var = (torch.mean(torch.abs(resid) ** 2, dim=(-2, -1))
                     * (ndmrs / (ndmrs - 1)))
    else:
        d = h_p[..., 1::2] - h_p[..., 0::2]
        noise_var = torch.mean(torch.abs(d) ** 2, dim=-1) / 2.0

    left, right, frac = _interp_on(tuple(int(p) for p in pilot_subcarriers),
                                   nsubc, h_p.device)
    hl = h_p[..., left]
    hr = h_p[..., right]
    h_freq = hl + (hr - hl) * frac
    return h_freq, noise_var.to(torch.float32), cfo
