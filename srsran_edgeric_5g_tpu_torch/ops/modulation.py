"""Modulation mapping and max-log soft demapping, TS 38.211 §5.1.

Port of ``srsran_edgeric_5g_tpu/ops/modulation.py``.

Mapper: bits -> constellation symbols by the closed-form Gray nesting per
axis.  Demapper: exact max-log LLRs per real axis by the Gray-fold
recursion, reproducing the reference's piecewise-linear interval functions:
  * LLR sign convention: positive <=> bit 0 (symbol amplitude (1-2b)),
  * scaling by the reciprocal noise variance,
  * int8 quantisation: clip to ±20 (±24 for BPSK/QPSK), then
    round(value * 120 / range) — round half to even, as jnp.round.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RANGE_LIMIT = 20.0       # QAM16/64/256
RANGE_LIMIT_PSK = 24.0   # BPSK/QPSK
LLR_MAX = 120

QM = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6, "qam256": 8}


def _axis_amplitude(m: int) -> float:
    """Per-axis unit of the 2**m-level PAM (unit average symbol energy), as
    the float32 value the reference computes with."""
    return float(np.float32(1.0 / np.sqrt(2.0 * (4 ** m - 1) / 3.0)))


def modulate(bits: torch.Tensor, modulation: str) -> torch.Tensor:
    """int8 {0,1} bits (..., nsym*Qm) -> complex64 symbols (..., nsym)."""
    qm = QM[modulation]
    s = (1 - 2 * bits.reshape(*bits.shape[:-1], -1, qm).to(torch.int32)
         ).to(torch.float32)                                  # (..., qm) signs
    if qm == 1:  # BPSK: d = ((1-2b) + j(1-2b)) / sqrt(2)
        v = s[..., 0] * float(np.float32(1 / np.sqrt(2)))
        return torch.complex(v, v)
    m = qm // 2
    a = _axis_amplitude(m)

    def _axis(sg):  # d/a = s_0*(2^{m-1} - s_1*(2^{m-2} - ... s_{m-1}))
        v = sg[..., m - 1]
        for j in range(m - 2, -1, -1):
            v = sg[..., j] * (float(1 << (m - 1 - j)) - v)
        return v * a

    return torch.complex(_axis(s[..., 0::2]), _axis(s[..., 1::2]))


def _axis_maxlog(y: torch.Tensor, noise_var_rcp: torch.Tensor,
                 qm: int) -> torch.Tensor:
    """Exact max-log LLRs for one real axis: (...,) -> (..., m), MSB first.

    LLR = (min_{bit=1} d^2 - min_{bit=0} d^2) * rcp_noise.  Bit j splits the
    current coordinate u_j by sign with 2^{m-1-j} levels per side at odd
    multiples of ``a``; the next bit lives in the reflected coordinate
    u_{j+1} = 2^{m-1-j}·a - |u_j|; the nearest level of each subset is a
    round + clamp."""
    m = qm // 2
    a = _axis_amplitude(m)
    u = y
    out = []
    for j in range(m):
        k = 1 << (m - 1 - j)
        if k == 1:
            lj = (4.0 * a) * u                     # (u+a)^2 - (u-a)^2
        else:
            kpos = torch.clamp(torch.round((u - a) / (2.0 * a)), 0, k - 1)
            kneg = torch.clamp(torch.round((-u - a) / (2.0 * a)), 0, k - 1)
            p = (2.0 * a) * kpos + a
            n = -((2.0 * a) * kneg + a)
            lj = (u - n) ** 2 - (u - p) ** 2
        out.append(lj)
        if j < m - 1:
            u = (k * a) - torch.abs(u)
    return torch.stack(out, dim=-1) * noise_var_rcp[..., None]


def demodulate_soft(symbols: torch.Tensor, noise_var: torch.Tensor,
                    modulation: str, quantize: bool = True) -> torch.Tensor:
    """Max-log soft demap: symbols (..., nsym) -> LLRs (..., nsym*Qm).

    ``noise_var`` broadcasts against ``symbols``.  With ``quantize`` the
    output is int8 in [-LLR_MAX, LLR_MAX]; otherwise float32.
    """
    qm = QM[modulation]
    nv = torch.as_tensor(noise_var, device=symbols.device).to(
        torch.float32).expand(symbols.shape)
    rcp = torch.where(nv > 0, 1.0 / torch.clamp(nv, min=1e-30), 0.0)
    re = symbols.real.to(torch.float32)
    im = symbols.imag.to(torch.float32)
    if qm == 1:
        llrs = ((2.0 * float(np.float32(math.sqrt(2.0)))) * (re + im) * rcp)[..., None]
    else:
        li = _axis_maxlog(re, rcp, qm)   # even bits b0, b2, ...
        lq = _axis_maxlog(im, rcp, qm)   # odd bits b1, b3, ...
        llrs = torch.stack([li, lq], dim=-1).reshape(*li.shape[:-1], -1)
    llrs = llrs.reshape(*symbols.shape[:-1], -1)
    if not quantize:
        return llrs
    return quantize_llrs(llrs, RANGE_LIMIT_PSK if qm <= 2 else RANGE_LIMIT)


def wire_quantize(llrs: torch.Tensor, modulation: str) -> torch.Tensor:
    """The reference's int8 wire quantisation kept in float dtype: clip to
    the constellation's range limit, scale to ±120 integer steps."""
    rl = RANGE_LIMIT_PSK if QM[modulation] <= 2 else RANGE_LIMIT
    scale = float(np.float32(LLR_MAX / rl))
    return torch.clamp(torch.round(llrs * scale), -LLR_MAX, LLR_MAX)


def quantize_llrs(llrs: torch.Tensor,
                  range_limit: float = RANGE_LIMIT) -> torch.Tensor:
    """Reference int8 quantisation: clip to ±range_limit, scale to ±120."""
    clipped = torch.clamp(llrs, -range_limit, range_limit)
    return torch.round(clipped * (LLR_MAX / range_limit)).to(torch.int8)
