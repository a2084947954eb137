"""Bit packing helpers and the GF(2) product (port of ``utils/bits.py``).

Coded bits are int8 {0,1} tensors on the hot path and are packed to uint8
only at host boundaries.
"""

from __future__ import annotations

import torch


def unpack_bits(packed: torch.Tensor, bit_order: str = "msb") -> torch.Tensor:
    """uint8 tensor (..., n) -> int8 bit tensor (..., n*8)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    if bit_order == "msb":
        shifts = shifts.flip(0)
    bits = (packed.to(torch.uint8)[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1).to(torch.int8)


def pack_bits(bits: torch.Tensor, bit_order: str = "msb") -> torch.Tensor:
    """int8 {0,1} tensor (..., n*8) -> uint8 tensor (..., n)."""
    *lead, n = bits.shape
    if n % 8:
        raise ValueError(f"bit count {n} is not a multiple of 8")
    b = bits.reshape(*lead, n // 8, 8).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    if bit_order == "msb":
        weights = weights.flip(0)
    return (b * weights).sum(dim=-1).to(torch.uint8)


def parity_dot(bits: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """GF(2) vector-matrix product ``(bits @ mat) mod 2``.

    ``bits``: (..., K) {0,1}; ``mat``: (K, M) {0,1}.  CUDA has no integer
    matmul, so this is a float32 matmul followed by mod 2: every partial sum
    is an integer below 2**24, hence exact (TF32 is off package-wide).
    """
    acc = torch.matmul(bits.to(torch.float32), mat.to(torch.float32))
    return torch.remainder(acc, 2.0).to(torch.int8)
