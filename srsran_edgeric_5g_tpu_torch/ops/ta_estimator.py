"""Time-alignment estimation from a channel frequency response.

Port of ``srsran_edgeric_5g_tpu/ops/ta_estimator.py`` (the reference's
DFT-based TA estimator with a 4096-point IDFT): take the per-subcarrier
channel estimate to the delay domain, find the correlation peak inside a
window, interpolate it quadratically for sub-bin resolution, and report it
in seconds.  With ``max_ta_s`` only the window's delay bins are evaluated,
as one complex matrix product against a cached IDFT operator.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

DFT_SIZE = 4096


@functools.lru_cache(maxsize=16)
def _window_idft(nsubc: int, dft_size: int, half: int) -> np.ndarray:
    """(nsubc, 2*half) IDFT operator evaluating only the delay bins
    [-half, half) of the ``dft_size``-point IDFT."""
    k = np.arange(nsubc)[:, None]
    m = np.arange(-half, half)[None, :]
    return (np.exp(2j * np.pi * k * m / dft_size) / dft_size
            ).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _window_idft_on(nsubc: int, dft_size: int, half: int,
                    device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_window_idft(nsubc, dft_size, half), device=device)


def estimate_ta(h_freq: torch.Tensor, scs_hz: float,
                dft_size: int = DFT_SIZE,
                max_ta_fraction: float = 0.25,
                max_ta_s: float | None = None) -> torch.Tensor:
    """(..., nsubc) channel estimate -> (...,) time alignment in seconds.

    Positive = the signal arrives late.  The peak search covers
    ±``max_ta_fraction`` of the IDFT span, or ±``max_ta_s`` seconds when
    given (then only those bins are computed)."""
    nsubc = h_freq.shape[-1]
    if nsubc > dft_size:
        raise ValueError(f"{nsubc} subcarriers exceed the {dft_size}-point IDFT")
    if max_ta_s is not None:
        half = max(2, min(int(np.ceil(max_ta_s * dft_size * scs_hz)),
                          dft_size // 2))
        e = _window_idft_on(nsubc, dft_size, half, h_freq.device)
        win_c = torch.matmul(h_freq.to(torch.complex64), e)   # (..., 2*half)
        win = win_c.real ** 2 + win_c.imag ** 2
        idx = torch.argmax(win, dim=-1)
        return _peak_interp(win, idx, half, dft_size, scs_hz)
    pad = dft_size - nsubc
    hp = torch.cat([h_freq, h_freq.new_zeros((*h_freq.shape[:-1], pad))], dim=-1)
    power = torch.fft.ifft(hp, dim=-1).abs() ** 2        # (..., dft)
    half = int(dft_size * max_ta_fraction)
    # Delays [-half, half): IDFT bins [dft - half, dft) then [0, half).
    win = torch.cat([power[..., dft_size - half:], power[..., :half]], dim=-1)
    idx = torch.argmax(win, dim=-1)
    return _peak_interp(win, idx, half, dft_size, scs_hz)


def _peak_interp(win: torch.Tensor, idx: torch.Tensor, half: int,
                 dft_size: int, scs_hz: float) -> torch.Tensor:
    """Quadratic (parabolic) peak interpolation for sub-bin resolution."""
    i0 = torch.clamp(idx, 1, 2 * half - 2)
    ym = torch.gather(win, -1, (i0 - 1)[..., None])[..., 0]
    y0 = torch.gather(win, -1, i0[..., None])[..., 0]
    yp = torch.gather(win, -1, (i0 + 1)[..., None])[..., 0]
    denom = ym - 2 * y0 + yp
    frac = torch.where(denom.abs() > 1e-20, 0.5 * (ym - yp) / denom,
                       torch.zeros_like(denom))
    delay_bins = i0.to(torch.float32) + frac - half
    # One IDFT bin spans 1 / (dft_size * scs) seconds.
    return (delay_bins / float(np.float32(dft_size * scs_hz))).to(torch.float32)
