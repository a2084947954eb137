"""Channel equalization: MMSE for 1 layer x N rx ports (SIMO).

Port of ``equalize_mmse_1xn`` in ``srsran_edgeric_5g_tpu/ops/equalizer.py``
(the reference's equalize_mmse_1xn.h:42-95, vectorised over all REs):

    x_hat = sum_p conj(h_p) y_p * |h|^2 / (|h|^4 + sum_p |h_p|^2 nvar_p)
    nvar_out = sum_p |h_p|^2 nvar_p / (|h|^4 + ...)        (unity gain)

with the reference's abnormal-input policy: ports with non-finite/zero
channel or non-positive noise variance are excluded; REs with no usable
port produce x_hat = 0 and nvar_out = +inf (the demapper emits zero LLRs).
"""

from __future__ import annotations

import torch


def _port_validity(h: torch.Tensor, noise_var: torch.Tensor) -> torch.Tensor:
    h_norm = h.real ** 2 + h.imag ** 2
    return (torch.isfinite(h_norm) & (h_norm > 0)
            & torch.isfinite(noise_var) & (noise_var > 0))


def equalize_mmse_1xn(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
                      tx_scaling: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """MMSE-equalize one spatial layer from N receive ports.

    Args:
      y: received REs, shape (ports, ...).
      h: channel estimates, shape (ports, ...) (broadcastable to y).
      noise_var: per-port noise variance, (ports, ...) broadcastable.
      tx_scaling: transmit amplitude scaling applied to the channel.

    Returns (x_hat complex64, nvar_out float32) with the ports axis reduced.
    """
    h = h * tx_scaling
    h_norm = h.real ** 2 + h.imag ** 2
    nv = torch.as_tensor(noise_var, device=h.device).to(torch.float32).expand(h_norm.shape)
    valid = _port_validity(h, nv)

    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    h_norm = torch.where(valid, h_norm, 0.0)
    ch_mod_sq = torch.sum(h_norm, dim=0)
    nvar_acc = torch.sum(torch.where(valid, h_norm * nv, 0.0), dim=0)
    mf = torch.sum(torch.where(valid, y * torch.conj(h), zero), dim=0)

    ok = ((ch_mod_sq > 0) & torch.isfinite(ch_mod_sq)
          & (nvar_acc > 0) & torch.isfinite(nvar_acc))
    denom = ch_mod_sq * ch_mod_sq + nvar_acc
    d_rcp = torch.where(ok, 1.0 / torch.where(ok, denom, 1.0), 0.0)

    x_hat = torch.where(ok, mf * (ch_mod_sq * d_rcp), zero)
    nvar_out = torch.where(ok, nvar_acc * d_rcp, float("inf"))
    return x_hat.to(torch.complex64), nvar_out.to(torch.float32)
