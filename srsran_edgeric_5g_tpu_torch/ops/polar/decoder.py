"""Polar successive-cancellation decoder, batched, with SSC pruning.

Port of ``srsran_edgeric_5g_tpu/ops/polar/decoder.py`` (the reference's SC
butterfly, polar_decoder_impl.cpp).  The tree is unrolled in Python from the
static frozen mask; rate-0 subtrees (all frozen) return known zeros and
rate-1 subtrees (no frozen bits) decode in one shot through the self-inverse
transform.  Every node is a few small operations over (B, subtree) tensors,
so on the card a decode is some hundreds of small launches.

PC bits (dynamic frozen, TS 38.212 §5.3.1.2) take the value of a length-5
cyclic register that every u index rotates and every decided bit enters;
the DCI input interleaver is undone on the way out.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .code import PolarCode
from .encoder import transform


def _f(a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """Check-node LLR combine: sign(a1)sign(a2)min(|a1|,|a2|)."""
    s = torch.sign(a1) * torch.sign(a2)
    s = torch.where(s == 0, 1.0, s)
    return s * torch.minimum(a1.abs(), a2.abs())


@functools.lru_cache(maxsize=None)
def _phase_mask(size: int) -> np.ndarray:
    """(size, 5) map of a decoded block onto the register: u_j ends up at
    phase (size-1-j) mod 5 after the remaining rotations."""
    mask = np.zeros((size, 5), dtype=np.float32)
    mask[np.arange(size), (size - 1 - np.arange(size)) % 5] = 1.0
    return mask


def _fold_phases(u: torch.Tensor, size: int) -> torch.Tensor:
    acc = torch.matmul(u.to(torch.float32),
                       torch.as_tensor(_phase_mask(size), device=u.device))
    return torch.remainder(acc, 2.0).to(torch.int8)


def _rot_reg(reg: torch.Tensor, m: int) -> torch.Tensor:
    return torch.roll(reg, m % 5, dims=-1)


def decode(llrs: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """(B, N) mother-code LLRs (positive <=> bit 0) -> (B, K) message bits.

    Undoes the DCI input interleaver when the code used i_IL=1; honours PC
    bits (dynamic frozen from the length-5 register) when the code has them.
    """
    frozen_mask = np.ones(code.nof_bits, dtype=bool)
    frozen_mask[code.info_set] = False
    pc_mask = np.zeros(code.nof_bits, dtype=bool)
    pc_mask[code.pc_set] = True
    b = llrs.shape[0]
    dev = llrs.device

    def rec(alpha, lo, size, reg):
        sub = frozen_mask[lo:lo + size]
        has_pc = pc_mask[lo:lo + size].any()
        if sub.all() and not has_pc:   # rate-0: all bits known zero
            z = torch.zeros((b, size), dtype=torch.int8, device=dev)
            return z, z, _rot_reg(reg, size)
        if not sub.any() and not has_pc:  # rate-1: u = beta * G (G^-1 = G)
            beta = (alpha < 0).to(torch.int8)
            u = transform(beta)
            reg = torch.bitwise_xor(_rot_reg(reg, size), _fold_phases(u, size))
            return beta, u, reg
        if size == 1:
            reg = _rot_reg(reg, 1)
            if pc_mask[lo]:
                u = reg[:, 0:1].clone()
                reg = reg.clone()
                reg[:, 0] = 0                # y0 ^= u with u = y0
                return u, u, reg
            # frozen (info leaves are covered by the rate-1 branch)
            z = torch.zeros((b, 1), dtype=torch.int8, device=dev)
            return z, z, reg
        half = size // 2
        a1, a2 = alpha[:, :half], alpha[:, half:]
        bl, ul, reg = rec(_f(a1, a2), lo, half, reg)
        ar = a2 + (1.0 - 2.0 * bl.to(torch.float32)) * a1
        br, ur, reg = rec(ar, lo + half, half, reg)
        beta = torch.cat([torch.bitwise_xor(bl, br), br], dim=1)
        return beta, torch.cat([ul, ur], dim=1), reg

    reg0 = torch.zeros((b, 5), dtype=torch.int8, device=dev)
    _, u, _ = rec(llrs.to(torch.float32), 0, code.nof_bits, reg0)
    bits = u[:, torch.as_tensor(code.info_set, device=dev)]
    if code.dci_interleave is not None:
        inv = np.empty(code.k, dtype=np.int64)
        inv[code.dci_interleave] = np.arange(code.k)
        bits = bits[:, torch.as_tensor(inv, device=dev)]
    return bits
