"""Low-PAPR (Zadoff-Chu) base sequences, TS 38.211 §5.2.2.

Port of ``srsran_edgeric_5g_tpu/ops/low_papr.py``: the sequences
r_{u,v}(n) of PUCCH formats 0/1 and SRS, built on the host, and their
cyclically shifted form r^(alpha)_{u,v}(n) as a tensor.  For
M_zc >= 36, r_{u,v}(n) = x_q(n mod N_zc) with x_q(m) = exp(-j pi q m (m+1) /
N_zc) and N_zc the largest prime below M_zc; for 1-4 PRB the spec's phi
tables apply (this package's ``data/ldpc_graphs.npz``).
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from ..device import resolve_device
from ..utils.tracing import cached_build

_DATA = pathlib.Path(__file__).resolve().parents[1] / "data" / "ldpc_graphs.npz"


@cached_build
def _phi_tables() -> dict[int, np.ndarray]:
    d = np.load(_DATA)
    return {6: d["phi_m6"], 12: d["phi_m12"],
            18: d["phi_m18"], 24: d["phi_m24"]}


@cached_build
def largest_prime_below(n: int) -> int:
    for c in range(n - 1, 1, -1):
        if all(c % d for d in range(2, int(c ** 0.5) + 1)):
            return c
    raise ValueError(n)


@cached_build
def base_sequence(u: int, v: int, m_zc: int) -> np.ndarray:
    """r_{u,v}(n), n = 0..M_zc-1, complex64."""
    if m_zc in (6, 12, 18, 24):
        return np.exp(1j * _phi_tables()[m_zc][u] * np.pi / 4).astype(np.complex64)
    if m_zc < 36:
        raise NotImplementedError(f"phi table for M_zc={m_zc} not included")
    n_zc = largest_prime_below(m_zc)
    q_bar = n_zc * (u + 1) / 31.0
    q = int(np.floor(q_bar + 0.5)) + v * (-1) ** int(np.floor(2 * q_bar))
    m = np.arange(n_zc, dtype=np.float64)
    x_q = np.exp(-1j * np.pi * q * m * (m + 1) / n_zc)
    return x_q[np.arange(m_zc) % n_zc].astype(np.complex64)


def low_papr_sequence(u: int, v: int, alpha: float, m_zc: int,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """r^(alpha)_{u,v}(n) = e^{j alpha n} r_{u,v}(n), complex64 on ``device``."""
    n = np.arange(m_zc)
    seq = (np.exp(1j * alpha * n) * base_sequence(u, v, m_zc)).astype(np.complex64)
    return torch.as_tensor(seq, device=resolve_device(device))
