"""CRC calculators for TS 38.212 §5.1 (CRC24A/B/C, CRC16, CRC11, CRC6).

Port of ``srsran_edgeric_5g_tpu/ops/crc.py``: a CRC over an N-bit message is
a GF(2) linear map, so per (polynomial, N) the N x L remainder table
``T[i] = x^(N-1-i+L) mod g`` is built once on the host and the CRC is
``(m @ T) mod 2`` — one float32 matmul batched over codeblocks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.bits import parity_dot
from ..utils.tracing import cached_build

# Generator polynomials, TS 38.212 §5.1 (low L bits below x^L; x^L implicit).
CRC24A = ("crc24a", 24, 0x864CFB)
CRC24B = ("crc24b", 24, 0x800063)
CRC24C = ("crc24c", 24, 0xB2B117)
CRC16 = ("crc16", 16, 0x1021)
CRC11 = ("crc11", 11, 0x621)
CRC6 = ("crc6", 6, 0x21)

BY_NAME = {p[0]: p for p in (CRC24A, CRC24B, CRC24C, CRC16, CRC11, CRC6)}


@cached_build
def remainder_table(name: str, msg_len: int) -> np.ndarray:
    """(msg_len, L) uint8 table; row i = x^(msg_len-1-i+L) mod g as bits (MSB first)."""
    _, n_crc, poly = BY_NAME[name]
    g = ((poly >> np.arange(n_crc - 1, -1, -1)) & 1).astype(np.uint8)
    r = g.copy()                       # x^L mod g
    table = np.empty((msg_len, n_crc), dtype=np.uint8)
    table[msg_len - 1] = r
    for i in range(msg_len - 2, -1, -1):
        # multiply by x: shift left; if the bit leaving is 1, subtract g.
        carry = r[0]
        r = np.roll(r, -1)
        r[-1] = 0
        if carry:
            r ^= g
        table[i] = r
    return table


@cached_build
def _table_on(name: str, msg_len: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(remainder_table(name, msg_len), dtype=torch.float32,
                           device=device)


def crc(bits: torch.Tensor, name: str) -> torch.Tensor:
    """CRC bits (..., L), MSB first, of int8 {0,1} messages (..., N)."""
    return parity_dot(bits, _table_on(name, bits.shape[-1], bits.device))


def crc_attach(bits: torch.Tensor, name: str) -> torch.Tensor:
    """Append the CRC to the message along the last axis."""
    bits = bits.to(torch.int8)
    return torch.cat([bits, crc(bits, name)], dim=-1)


def crc_check(bits_with_crc: torch.Tensor, name: str) -> torch.Tensor:
    """Boolean (...,): True where the trailing CRC is consistent (the
    remainder of message + CRC is zero)."""
    return torch.all(crc(bits_with_crc, name) == 0, dim=-1)


def np_crc(bits: np.ndarray, name: str) -> np.ndarray:
    """Host bitwise long-division CRC of a (N,) {0,1} message -> (L,) uint8
    (MSB first): an oracle independent of the remainder tables."""
    _, n_crc, poly = BY_NAME[name]
    g = int(poly) | (1 << n_crc)
    reg = 0
    for b in bits.astype(int):
        reg = (reg << 1) | int(b)
        if reg >> n_crc:
            reg ^= g
    for _ in range(n_crc):                 # flush L zero bits
        reg <<= 1
        if reg >> n_crc:
            reg ^= g
    return ((reg >> np.arange(n_crc - 1, -1, -1)) & 1).astype(np.uint8)
