"""Short-block UCI coding (TS 38.212 §5.3.3): K=1 repetition, K=2 simplex,
3 <= K <= 11 Reed-Muller (32, K), and ML soft detection.

Port of ``encode`` / ``detect`` in ``srsran_edgeric_5g_tpu/ops/short_block.py``.
Encoding is a GF(2) product with the RM basis (this package's
``data/ldpc_graphs.npz``); detection is one (B, E) x (E, 2^K) correlation
against the whole codebook.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from ..utils.bits import parity_dot
from ..utils.tracing import cached_build

_DATA = pathlib.Path(__file__).resolve().parents[1] / "data" / "ldpc_graphs.npz"


@cached_build
def rm_basis() -> np.ndarray:
    """(11, 32) int8 basis sequences M_i(n) (Table 5.3.3.3-1)."""
    return np.load(_DATA)["rm_basis_sequences"]


@cached_build
def _codebook(k: int, e: int) -> np.ndarray:
    """(2^K, E) every codeword as ±1 float32 (bit 0 -> +1); message m has
    bit i = (m >> i) & 1."""
    msgs = ((np.arange(1 << k)[:, None] >> np.arange(k)) & 1).astype(np.int8)
    if k == 1:
        cw = np.broadcast_to(msgs, (2, e))
    elif k == 2:
        trip = np.stack([msgs[:, 0], msgs[:, 1], msgs[:, 0] ^ msgs[:, 1]], axis=1)
        cw = np.tile(trip, (1, -(-e // 3)))[:, :e]
    else:
        d = (msgs.astype(np.int64) @ rm_basis()[:k].astype(np.int64)) % 2
        cw = np.tile(d, (1, -(-e // 32)))[:, :e]
    return (1.0 - 2.0 * cw).astype(np.float32)


@cached_build
def _tensors(k: int, e: int, device: torch.device):
    return (torch.as_tensor(rm_basis()[:k].astype(np.float32), device=device),
            torch.as_tensor(_codebook(k, e).T.copy(), device=device))


def encode(bits: torch.Tensor, e: int) -> torch.Tensor:
    """(B, K) UCI bits, K in 1..11 -> (B, E) coded bits: K=1 repeats c0,
    K=2 cycles [c0, c1, c0^c1], K>=3 is RM(32, K) cyclically repeated."""
    b, k = bits.shape
    bits = bits.to(torch.int8)
    if k == 1:
        return bits.expand(b, e)
    if k == 2:
        trip = torch.stack([bits[:, 0], bits[:, 1], bits[:, 0] ^ bits[:, 1]], 1)
        return trip.repeat(1, -(-e // 3))[:, :e]
    if not 3 <= k <= 11:
        raise ValueError(f"short-block codes take 1 <= K <= 11, got {k}")
    d = parity_dot(bits, _tensors(k, e, bits.device)[0])
    return d.repeat(1, -(-e // 32))[:, :e]


def detect(llrs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ML detection: (B, E) LLRs -> ((B, K) bits, (B,) correlation metric),
    argmax_m <llr, 1 - 2 c_m> over all 2^K codewords."""
    corr = torch.matmul(llrs.to(torch.float32),
                        _tensors(k, llrs.shape[-1], llrs.device)[1])
    metric, best = corr.max(dim=-1)
    shifts = torch.arange(k, device=llrs.device)
    return ((best[:, None] >> shifts) & 1).to(torch.int8), metric
