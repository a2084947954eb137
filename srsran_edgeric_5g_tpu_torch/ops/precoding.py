"""Channel precoding and transform precoding.

Port of ``srsran_edgeric_5g_tpu/ops/precoding.py``:
  * channel precoder: per-RE layers -> ports complex matrix product, one
    einsum over the whole grid;
  * transform precoder: DFT-s-OFDM spreading for PUSCH, a batched unitary
    (i)DFT over each M_sc-sized block (``torch.fft``).

Valid DFT-s-OFDM sizes are M_sc = 12 * 2^a 3^b 5^c (TS 38.211 §6.3.1.4).
"""

from __future__ import annotations

import numpy as np
import torch


def apply_precoding(layers: torch.Tensor, weights) -> torch.Tensor:
    """(..., nlayers, nre) x (nports, nlayers) -> (..., nports, nre).

    The weight matrix may also be per-RE: (..., nports, nlayers, nre)."""
    w = torch.as_tensor(weights, device=layers.device).to(torch.complex64)
    x = layers.to(torch.complex64)
    if w.ndim == 2:
        return torch.einsum("pl,...lr->...pr", w, x)
    return torch.einsum("...plr,...lr->...pr", w, x)


def identity_precoding(nports: int, nlayers: int,
                       scale: float | None = None) -> np.ndarray:
    """One-layer-per-port mapping with 1/sqrt(nlayers) power normalisation."""
    w = np.zeros((nports, nlayers), dtype=np.complex64)
    for l in range(nlayers):
        w[l % nports, l] += 1.0
    w *= np.float32(1.0 / np.sqrt(nlayers) if scale is None else scale)
    return w


def is_valid_dftsofdm_size(m_sc: int) -> bool:
    """M_sc must be 12 * 2^a 3^b 5^c."""
    if m_sc % 12:
        return False
    n = m_sc // 12
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def _check_size(m_sc: int) -> None:
    if not is_valid_dftsofdm_size(m_sc):
        raise ValueError(f"M_sc = {m_sc} is not 12 * 2^a 3^b 5^c")


def transform_precode(symbols: torch.Tensor, m_sc: int) -> torch.Tensor:
    """DFT-s-OFDM spread: (..., nblocks*m_sc) -> same shape, per-block DFT.

    y[k] = (1/sqrt(M)) sum_n x[n] e^{-j2 pi k n / M} (TS 38.211 §6.3.1.4)."""
    _check_size(m_sc)
    shp = symbols.shape
    x = symbols.to(torch.complex64).reshape(*shp[:-1], -1, m_sc)
    y = torch.fft.fft(x, dim=-1) * float(np.float32(1.0 / np.sqrt(m_sc)))
    return y.reshape(shp).to(torch.complex64)


def transform_deprecode(symbols: torch.Tensor, m_sc: int) -> torch.Tensor:
    """Inverse DFT-s-OFDM: per-block scaled iDFT."""
    _check_size(m_sc)
    shp = symbols.shape
    x = symbols.to(torch.complex64).reshape(*shp[:-1], -1, m_sc)
    y = torch.fft.ifft(x, dim=-1) * float(np.float32(np.sqrt(m_sc)))
    return y.reshape(shp).to(torch.complex64)
