"""UCI channel coding (TS 38.212 §6.3.1): any payload size K -> E bits.

Port of ``srsran_edgeric_5g_tpu/ops/uci.py`` (the reference's
uci_decoder_impl.cpp): K <= 11 goes to the short-block code, K >= 12
through the polar chain (CRC6 + 3 PC bits for 12 <= K <= 19, CRC11 for
K >= 20, both with the UCI triangular i_BIL coded-bit interleaver).  Shared
by PUCCH Format 2 and UCI on PUSCH.
"""

from __future__ import annotations

import torch

from . import short_block
from .crc import crc_attach
from .polar import code as polar_code, list_decoder as polar_list
from .polar import encoder as polar_encoder, rate_match as polar_rm


def uci_polar_code(k: int, e: int):
    """UCI polar construction (TS 38.212 §6.3.1.2 / §6.3.1.3.1): 12 <= K <=
    19 uses CRC6 + 3 PC bits; K >= 20 uses CRC11 (no PC)."""
    if k <= 19:
        return polar_code.construct(k + 6, e, nmax=polar_code.NMAX_UL,
                                    i_il=False, n_pc=3, i_bil=True), "crc6"
    return polar_code.construct(k + 11, e, nmax=polar_code.NMAX_UL,
                                i_il=False, i_bil=True), "crc11"


def encode(bits: torch.Tensor, e: int) -> torch.Tensor:
    """(B, K) UCI bits -> (B, E) coded bits (short block for K <= 11; polar
    with CRC6 + PC for 12 <= K <= 19, CRC11 for K >= 20)."""
    k = bits.shape[-1]
    if k <= 11:
        return short_block.encode(bits, e)
    c, crc_name = uci_polar_code(k, e)
    cw = polar_encoder.encode(crc_attach(bits, crc_name), c)
    return polar_rm.rate_match(cw, c)


def decode(llrs: torch.Tensor, k: int, e: int, list_size: int = 8
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, E) LLRs -> ((B, K) UCI bits, (B,) valid).

    K <= 11: short-block ML detection (valid = positive metric).  K >= 12:
    CA-SCL polar (a per-path PC register for the CRC6 + PC codes; valid =
    the CRC-selected path)."""
    if k <= 11:
        bits, metric = short_block.detect(llrs, k)
        return bits, metric > 0
    c, crc_name = uci_polar_code(k, e)
    decoded, ok = polar_list.decode_scl(polar_rm.rate_dematch(llrs, c), c,
                                        list_size=list_size, crc=crc_name)
    return decoded[:, :k], ok
