"""The GF(2) product: int8 {0,1} bits times a 0/1 matrix, as a float32
matmul whose integer sums stay exact.
"""
from __future__ import annotations

import torch


def parity_dot(bits: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """GF(2) vector-matrix product ``(bits @ mat) mod 2``.

    ``bits``: (..., K) {0,1}; ``mat``: (K, M) {0,1}.  CUDA has no integer
    matmul, so this is a float32 matmul followed by mod 2: every partial sum
    is an integer below 2**24, hence exact (TF32 is off package-wide).
    """
    acc = torch.matmul(bits.to(torch.float32), mat.to(torch.float32))
    return torch.remainder(acc, 2.0).to(torch.int8)

