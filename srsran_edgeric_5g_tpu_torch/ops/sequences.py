"""Pseudo-random (Gold) sequence generation, TS 38.211 §5.2.1.

Port of ``srsran_edgeric_5g_tpu/ops/sequences.py``.  c(n) = x1(n+Nc) XOR
x2(n+Nc) is linear in the 31-bit initialiser of x2, so for a length N the
host builds once

  * ``x1_part``: the (N,) constant x1(n+Nc) stream (x1's init is fixed), and
  * ``basis``:   the (31, N) matrix whose row i is x2(n+Nc) for c_init = e_i,

and a batch of sequences is ``x1_part XOR ((cinit_bits @ basis) mod 2)``:
one (B, 31) x (31, N) matmul, no sequential LFSR state.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.bits import parity_dot

NC = 1600


def _step_matrix(taps: tuple[int, ...]) -> np.ndarray:
    """31x31 GF(2) matrix S: next 31 outputs = previous 31 outputs @ S, for
    the recurrence x(n+31) = XOR_j x(n+tap_j)."""
    seq = np.zeros((31, 62), dtype=np.uint8)
    seq[:, :31] = np.eye(31, dtype=np.uint8)
    for n in range(31):
        acc = np.zeros(31, dtype=np.uint8)
        for t in taps:
            acc ^= seq[:, n + t]
        seq[:, n + 31] = acc
    return seq[:, 31:]


def _run_blocks(start_block: np.ndarray, taps: tuple[int, ...], total: int) -> np.ndarray:
    """``total`` outputs for each of B sequences given their first-31
    outputs ``start_block`` (B, 31)."""
    step = _step_matrix(taps).astype(np.int64)
    nblocks = -(-total // 31) + 1
    blocks = np.empty((nblocks, start_block.shape[0], 31), dtype=np.uint8)
    blk = start_block.copy()
    for k in range(nblocks):
        blocks[k] = blk
        blk = (blk.astype(np.int64) @ step) % 2
    out = np.transpose(blocks, (1, 0, 2)).reshape(start_block.shape[0], -1)
    return out[:, :total].astype(np.uint8)


@functools.lru_cache(maxsize=None)
def gold_tables(length: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (x1_part (length,), basis (31, length)) for sequence length N."""
    # x1: x1(n+31) = x1(n+3) ^ x1(n); init x1(0)=1, rest 0.
    x1_start = np.zeros((1, 31), dtype=np.uint8)
    x1_start[0, 0] = 1
    x1 = _run_blocks(x1_start, (0, 3), NC + length)[0, NC:]
    # x2 basis: x2(n+31) = x2(n+3) ^ x2(n+2) ^ x2(n+1) ^ x2(n); init rows e_i.
    basis = _run_blocks(np.eye(31, dtype=np.uint8), (0, 1, 2, 3), NC + length)[:, NC:]
    return x1, basis


@functools.lru_cache(maxsize=None)
def _tables_on(length: int, device: torch.device):
    x1, basis = gold_tables(length)
    return (torch.as_tensor(x1, dtype=torch.int8, device=device),
            torch.as_tensor(basis, dtype=torch.float32, device=device))


def gold_sequence(c_init: torch.Tensor, length: int) -> torch.Tensor:
    """Gold sequence bits c(0..length-1) as int8 {0,1}, batched over c_init
    (any integer tensor of 31-bit initialisers)."""
    x1, basis = _tables_on(length, c_init.device)
    shifts = torch.arange(31, dtype=torch.int64, device=c_init.device)
    cbits = (c_init.to(torch.int64)[..., None] >> shifts) & 1
    return torch.bitwise_xor(parity_dot(cbits, basis), x1)


def np_gold_sequence(c_init: int, length: int) -> np.ndarray:
    """Host-side straightforward LFSR (int8 {0,1}): the host constants of the
    control channels (pilots, DM-RS, cyclic-shift tables) are built with it."""
    n = NC + length
    x1 = np.zeros(n + 31, dtype=np.uint8)
    x2 = np.zeros(n + 31, dtype=np.uint8)
    x1[0] = 1
    for i in range(31):
        x2[i] = (c_init >> i) & 1
    for i in range(n):
        x1[i + 31] = x1[i + 3] ^ x1[i]
        x2[i + 31] = x2[i + 3] ^ x2[i + 2] ^ x2[i + 1] ^ x2[i]
    # int8, so that (1 - 2*c) cannot wrap as uint8 would.
    return (x1[NC:NC + length] ^ x2[NC:NC + length]).astype(np.int8)


def scramble_bits(bits: torch.Tensor, c_init: torch.Tensor) -> torch.Tensor:
    """XOR a {0,1} bit stream (..., N) with per-row Gold sequences."""
    seq = gold_sequence(c_init, bits.shape[-1])
    return torch.bitwise_xor(bits.to(torch.int8), seq)


def scramble_llrs(llrs: torch.Tensor, c_init: torch.Tensor) -> torch.Tensor:
    """Descramble soft bits: flip the LLR sign where the sequence bit is 1."""
    seq = gold_sequence(c_init, llrs.shape[-1])
    return llrs * (1 - 2 * seq).to(llrs.dtype)
