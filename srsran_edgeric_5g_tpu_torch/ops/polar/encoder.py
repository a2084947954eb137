"""Polar encoding (TS 38.212 §5.3.1.2) as GF(2) products.

Port of ``allocate`` / ``transform`` / ``encode`` in
``srsran_edgeric_5g_tpu/ops/polar/encoder.py``.  The reference's butterfly
stages become one product with the generator G_N = F^{(x)n}, and ``encode``
folds the allocation (input interleaver, information positions, parity-check
bits) into the same matrix: x = msg @ (A G_N) over GF(2), one float32 matmul
per batch through ``utils.bits.parity_dot`` (column sums stay far below
2^24, so exact).
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.bits import parity_dot
from .code import PolarCode
from ...utils.tracing import cached_build


@cached_build
def _pc_matrix(code: PolarCode) -> np.ndarray:
    """(K, n_pc) GF(2) map from (interleaved) info bits to PC-bit values.

    TS 38.212 §5.3.1.2 PC register: a length-5 register rotates once per u
    index and u_i is XORed into y[0], so the value read at a PC position p is
    the XOR of u_j over j < p with j = p (mod 5); PC-on-PC dependencies are
    resolved by substitution into info-bit masks."""
    info = code.info_set
    masks = {}
    for p in sorted(code.pc_set.tolist()):
        m = np.zeros(code.k, dtype=np.uint8)
        for j_idx, j in enumerate(info):
            if j < p and (p - j) % 5 == 0:
                m[j_idx] ^= 1
        for q, mq in masks.items():
            if q < p and (p - q) % 5 == 0:
                m ^= mq
        masks[p] = m
    return (np.stack([masks[p] for p in sorted(masks)], axis=1) if masks
            else np.zeros((code.k, 0), np.uint8))


@cached_build
def generator(n_bits: int) -> np.ndarray:
    """(N, N) uint8 G_N = F^{(x)n}, F = [[1, 0], [1, 1]]."""
    g = np.ones((1, 1), dtype=np.uint8)
    for _ in range(int(np.log2(n_bits))):
        g = np.kron(g, np.array([[1, 0], [1, 1]], dtype=np.uint8))
    return g


@cached_build
def _allocation(code: PolarCode) -> np.ndarray:
    """(K, N) GF(2) map from message bits to the u-domain vector."""
    perm = (code.dci_interleave if code.dci_interleave is not None
            else np.arange(code.k))
    a = np.zeros((code.k, code.nof_bits), dtype=np.int64)
    a[perm, code.info_set] = 1
    if code.n_pc:
        a[perm[:, None], code.pc_set[None, :]] ^= _pc_matrix(code).astype(np.int64)
    return a


@cached_build
def _tensors(code: PolarCode, device: torch.device):
    alloc = _allocation(code)
    enc = (alloc @ generator(code.nof_bits).astype(np.int64)) % 2
    return (torch.as_tensor(alloc, dtype=torch.float32, device=device),
            torch.as_tensor(generator(code.nof_bits), dtype=torch.float32,
                            device=device),
            torch.as_tensor(enc, dtype=torch.float32, device=device))


def allocate(msg_bits: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """(B, K) message bits -> (B, N) u-domain vector (frozen = 0), with the
    DCI input interleaver and the parity-check bits when the code has them."""
    return parity_dot(msg_bits, _tensors(code, msg_bits.device)[0])


def transform(u: torch.Tensor) -> torch.Tensor:
    """x = u G_N over GF(2)."""
    g = torch.as_tensor(generator(u.shape[-1]), dtype=torch.float32,
                        device=u.device)
    return parity_dot(u, g)


def encode(msg_bits: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """(B, K) -> (B, N) polar-encoded mother codeword (allocate + transform
    as one product)."""
    return parity_dot(msg_bits, _tensors(code, msg_bits.device)[2])


def np_encode(msg_bits: np.ndarray, code: PolarCode) -> np.ndarray:
    """Host oracle: the PC register walk (TS 38.212 §5.3.1.2) bit by bit,
    then the Kronecker generator: (B, K) -> (B, N) over GF(2)."""
    f = np.array([[1, 0], [1, 1]], dtype=np.int64)
    g = np.array([[1]], dtype=np.int64)
    for _ in range(code.n):
        g = np.kron(g, f)
    bits = msg_bits
    if code.dci_interleave is not None:
        bits = bits[:, code.dci_interleave]
    nb = code.nof_bits
    u = np.zeros((msg_bits.shape[0], nb), dtype=np.int64)
    info = set(code.info_set.tolist())
    pc = set(code.pc_set.tolist())
    for row in range(msg_bits.shape[0]):
        y = np.zeros(5, dtype=np.int64)
        next_bit = iter(bits[row])
        for i in range(nb):
            y = np.roll(y, 1)              # cyclic shift, y[0] <- y[4]
            if i in pc:
                u[row, i] = y[0]
            elif i in info:
                u[row, i] = int(next(next_bit))
            y[0] ^= u[row, i]
    return (u @ g) % 2
