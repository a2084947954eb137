"""OFDM slot modulation / demodulation (TS 38.211 §5.3-5.4).

Port of ``modulate_slot`` / ``demodulate_slot`` in
``srsran_edgeric_5g_tpu/ops/ofdm.py`` on ``torch.fft`` (the reference's
TPU matmul-DFT is a TPU workaround and is not ported): whole slots per
call, one batched (i)FFT over all symbols, CP insertion / stripping as one
static gather.

Conventions (matching the reference):
  * Subcarrier k=0..nsubc-1 maps to FFT bin (k - nsubc/2) mod nfft.
  * iFFT/FFT are unnormalised (FFTW convention); ``scale`` multiplies the
    output.
  * Phase compensation per TS 38.211 §5.4: symbol l is scaled by
    exp(-+j 2 pi f_c t_l), t_l the start of its useful part in the subframe.
  * CP insertion copies the tail of the useful part ahead of it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ran.numerology import SlotTiming


@functools.lru_cache(maxsize=None)
def _subcarrier_bins(nsubc: int, nfft: int, device: torch.device) -> torch.Tensor:
    """FFT bin index per subcarrier (negative half at the top)."""
    k = np.arange(nsubc)
    return torch.as_tensor((k - nsubc // 2) % nfft, device=device)


@functools.lru_cache(maxsize=None)
def _cp_gather_index(nfft: int, cps: tuple, device: torch.device) -> torch.Tensor:
    """(total,) gather index into the flat (nsymb*nfft,) symbol buffer that
    produces the CP-inserted time-domain slot."""
    out = []
    for l, cp in enumerate(cps):
        base = l * nfft
        out.append(base + np.arange(nfft - cp, nfft))  # CP = tail copy
        out.append(base + np.arange(nfft))
    return torch.as_tensor(np.concatenate(out), device=device)


@functools.lru_cache(maxsize=None)
def _data_gather_index(nfft: int, cps: tuple, window_offset: int,
                       device: torch.device) -> torch.Tensor:
    """(nsymb, nfft) gather index into the (total,) slot samples selecting the
    useful (post-CP) part of each symbol."""
    starts = np.cumsum([0] + [cp + nfft for cp in cps[:-1]]) + np.asarray(cps)
    idx = starts[:, None] + np.arange(nfft)[None, :] - window_offset
    return torch.as_tensor(idx, device=device)


def phase_compensation(timing: SlotTiming, center_freq_hz: float,
                       is_tx: bool, slot_in_subframe: int = 0) -> np.ndarray:
    """(nsymb,) complex64 coefficients exp(-+ j 2 pi f_c t_l), t_l the start
    of the useful symbol part from the start of the subframe."""
    t0 = slot_in_subframe * timing.cp.total
    t_useful = (np.asarray(timing.cp.data_starts) + t0) / timing.srate
    sign = -1.0 if is_tx else 1.0
    ph = sign * 2.0 * np.pi * center_freq_hz * t_useful
    return np.exp(1j * ph).astype(np.complex64)


def modulate_slot(grid: torch.Tensor, timing: SlotTiming,
                  center_freq_hz: float = 0.0, scale: float = 1.0,
                  slot_in_subframe: int = 0) -> torch.Tensor:
    """Resource grid (..., nsymb, nsubc) -> baseband samples (..., total).

    Unnormalised iDFT x scale x per-symbol phase compensation, CP inserted.
    """
    nsymb, nsubc = grid.shape[-2:]
    if nsymb != timing.nsymb or nsubc != timing.nof_subc:
        raise ValueError(f"grid {tuple(grid.shape)} does not match {timing}")
    nfft = timing.nfft
    dev = grid.device
    x = torch.zeros((*grid.shape[:-1], nfft), dtype=torch.complex64, device=dev)
    x[..., _subcarrier_bins(nsubc, nfft, dev)] = grid.to(torch.complex64)
    coef = phase_compensation(timing, center_freq_hz, True, slot_in_subframe)
    coefs = torch.as_tensor(coef * np.complex64(scale), device=dev)
    td = torch.fft.ifft(x, dim=-1) * float(np.float32(nfft))  # FFTW backward
    td = td * coefs[:, None]
    flat = td.reshape(*td.shape[:-2], nsymb * nfft)
    return flat[..., _cp_gather_index(nfft, timing.cp.cp, dev)]


def demodulate_slot(samples: torch.Tensor, timing: SlotTiming,
                    center_freq_hz: float = 0.0, scale: float | None = None,
                    slot_in_subframe: int = 0,
                    window_offset: int = 0) -> torch.Tensor:
    """Baseband samples (..., total) -> resource grid (..., nsymb, nsubc).

    ``scale`` defaults to 1/nfft (inverts the unnormalised modulator at
    scale=1).  ``window_offset`` advances the DFT window into the CP by that
    many samples, compensated by a per-bin phase ramp.
    """
    nfft, nsubc = timing.nfft, timing.nof_subc
    if samples.shape[-1] != timing.cp.total:
        raise ValueError(f"{samples.shape[-1]} samples, slot has {timing.cp.total}")
    scale = 1.0 / nfft if scale is None else scale
    dev = samples.device
    seg = samples[..., _data_gather_index(nfft, timing.cp.cp, window_offset, dev)]
    coef = phase_compensation(timing, center_freq_hz, False, slot_in_subframe)
    coefs = torch.as_tensor(coef * np.complex64(scale), device=dev)
    fd = torch.fft.fft(seg, dim=-1).to(torch.complex64)
    fd = fd * coefs[:, None]
    if window_offset:
        omega = 2.0 * np.pi * window_offset / nfft
        ramp = np.exp(1j * omega * np.arange(nfft)).astype(np.complex64)
        fd = fd * torch.as_tensor(ramp, device=dev)
    return fd[..., _subcarrier_bins(nsubc, nfft, dev)]
