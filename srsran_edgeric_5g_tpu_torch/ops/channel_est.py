"""Port channel estimation from DM-RS pilots (PUSCH/PDSCH receive side).

Port of ``estimate_port`` and its helpers in
``srsran_edgeric_5g_tpu/ops/channel_est.py``:

  * LS at pilots: H_ls = Y * conj(P)  (unit-modulus QPSK pilots).
  * CFO from the phase of the correlation between the first and last DM-RS
    symbols, compensated before time averaging (>= 2 DM-RS symbols).
  * Noise variance from the time residual across DM-RS symbols (2+
    symbols) or the adjacent-pilot difference (one symbol).
  * Linear frequency interpolation/extrapolation to every subcarrier.

``estimate_port_ta`` adds the reference's time-alignment stage (derotate
the pilot-domain channel by its dominant delay before interpolating) and,
with a delay spread, a windowed-sinc frequency smoother over the pilots.
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


def _average_pilots(rx_pilots: torch.Tensor, ref_pilots: torch.Tensor,
                    dmrs_symbol_times_s: np.ndarray | None,
                    compensate_cfo: bool = True):
    """LS at the pilots, CFO estimate (and compensation), time average and
    noise variance: -> (h_p (..., npilots), noise_var (...,), cfo (...,))."""
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
    return h_p, noise_var.to(torch.float32), cfo


def _interpolate(h_p: torch.Tensor, pilot_subcarriers: np.ndarray,
                 nsubc: int) -> torch.Tensor:
    """Linear interpolation of (..., npilots) pilot estimates to (..., nsubc)."""
    left, right, frac = _interp_on(tuple(int(p) for p in pilot_subcarriers),
                                   nsubc, h_p.device)
    hl = h_p[..., left]
    hr = h_p[..., right]
    return hl + (hr - hl) * frac


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
    h_p, noise_var, cfo = _average_pilots(rx_pilots, ref_pilots,
                                          dmrs_symbol_times_s, compensate_cfo)
    return _interpolate(h_p, pilot_subcarriers, nsubc), noise_var, cfo


@functools.lru_cache(maxsize=None)
def _smooth_matrix(npil: int, delay_spread_s: float, pilot_scs: float,
                   half_len: int = 24) -> np.ndarray:
    """(npil, npil + 2*half_len) valid-convolution smoothing operator: a
    Hann-windowed sinc low-pass over the edge-extended pilot axis whose
    one-sided passband covers ``delay_spread_s``."""
    # Passband edge in cycles per pilot, plus half the windowed sinc's
    # transition width, so in-band delays sit on the flat part.
    fc = delay_spread_s * pilot_scs + 1.6 / (2 * half_len + 1)
    m = np.arange(-half_len, half_len + 1, dtype=np.float64)
    k = 2 * fc * np.sinc(2 * fc * m)
    k *= np.hanning(2 * half_len + 1 + 2)[1:-1]
    k /= k.sum()
    s = np.zeros((npil, npil + 2 * half_len), dtype=np.float64)
    for i in range(npil):
        s[i, i:i + 2 * half_len + 1] = k
    return s.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _smooth_matrix_t(npil: int, delay_spread_s: float, pilot_scs: float,
                     half_len: int, device: torch.device) -> torch.Tensor:
    """The smoothing operator's transpose on ``device``."""
    s = _smooth_matrix(npil, delay_spread_s, pilot_scs, half_len)
    return torch.as_tensor(np.ascontiguousarray(s.T), device=device)


def _freq_smooth(h_flat: torch.Tensor, delay_spread_s: float,
                 pilot_scs: float, half_len: int = 24) -> torch.Tensor:
    """Smooth a TA-derotated pilot-domain channel along frequency.

    The band edges are extended with the conjugate ramp
    h[-m] = h0^2 conj(h[m]) / |h0|^2, so the low-pass sees a
    phase-continuous sequence.  The product is float32, real and imaginary
    parts apart (the card's float32 matmul default, not TF32)."""
    n = half_len
    eps = 1e-20

    def ext(anchor, seg):                    # anchor: (..., 1), seg: (..., n)
        scale = anchor * anchor / (torch.abs(anchor) ** 2 + eps)
        return scale * torch.conj(seg)

    left = ext(h_flat[..., 0:1], torch.flip(h_flat[..., 1:n + 1], dims=(-1,)))
    right = ext(h_flat[..., -1:], torch.flip(h_flat[..., -n - 1:-1], dims=(-1,)))
    hext = torch.cat([left, h_flat, right], dim=-1)
    st = _smooth_matrix_t(h_flat.shape[-1], delay_spread_s, pilot_scs, half_len,
                          h_flat.device)
    return torch.complex(hext.real @ st, hext.imag @ st)


def estimate_port_ta(rx_pilots: torch.Tensor, ref_pilots: torch.Tensor,
                     pilot_subcarriers: np.ndarray, nsubc: int,
                     scs_hz: float,
                     dmrs_symbol_times_s: np.ndarray | None = None,
                     delay_spread_s: float | None = None):
    """``estimate_port`` with time-alignment-compensated interpolation.

    The dominant delay is estimated from the pilot-domain channel (±2.5 µs
    window of the 4096-point IDFT), its linear phase ramp is removed so the
    channel is about flat across the pilot gap, the result is interpolated
    and the ramp restored on the full band.  With ``delay_spread_s`` the
    derotation centres on ``ta + delay_spread/2`` and the pilots are
    smoothed over ``delay_spread/2`` plus a 0.3 µs guard first.

    Returns (h_freq, noise_var, cfo_hz, ta_seconds).
    """
    from .ta_estimator import estimate_ta

    h_p, noise_var, cfo = _average_pilots(rx_pilots, ref_pilots,
                                          dmrs_symbol_times_s)
    dev = h_p.device
    gap = int(pilot_subcarriers[1] - pilot_subcarriers[0])
    pilot_scs = gap * scs_hz
    ta = estimate_ta(h_p, pilot_scs, max_ta_s=2.5e-6)
    guard_s = 0.3e-6
    t_c = ta if delay_spread_s is None else ta + delay_spread_s / 2
    two_pi_scs = float(np.float32(2.0 * np.pi * scs_hz))
    pil_k = torch.as_tensor(np.asarray(pilot_subcarriers, dtype=np.float32),
                            device=dev)
    ph = (two_pi_scs * t_c)[..., None] * pil_k
    h_flat = h_p * torch.polar(torch.ones_like(ph), ph)

    if delay_spread_s is not None:
        h_flat = _freq_smooth(h_flat, delay_spread_s / 2 + guard_s, pilot_scs)

    h_freq = _interpolate(h_flat, pilot_subcarriers, nsubc)
    all_k = torch.arange(nsubc, dtype=torch.float32, device=dev)
    ph = (-two_pi_scs * t_c)[..., None] * all_k
    h_freq = h_freq * torch.polar(torch.ones_like(ph), ph)
    return h_freq.to(torch.complex64), noise_var, cfo, ta
