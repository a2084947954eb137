"""Transport-block segmentation (TS 38.212 §5.2.2 + §7.2.2 BG selection).

Port of ``srsran_edgeric_5g_tpu/ops/ldpc/segmenter.py``: TB -> equal
codeblocks with CRC24B attach and filler zeros, plus the per-codeblock
rate-matched length split.  ``segment_tb`` turns a (B_tb, A) payload batch
into a (B_tb * C, K) codeblock batch: a reshape, a CRC matmul and padding.
"""

from __future__ import annotations

import dataclasses

import torch

from ..crc import crc_attach, crc_check
from .graph import BG1, BG2, KB_MAX, min_lifting_size
from ...utils.tracing import cached_build

MAX_K_CB = {BG1: 8448, BG2: 3840}


def select_base_graph(a: int, rate: float) -> int:
    """TS 38.212 §7.2.2: BG2 for small TBs / low rates, else BG1."""
    if a <= 292 or (a <= 3824 and rate <= 0.67) or rate <= 0.25:
        return BG2
    return BG1


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    bg: int
    a: int              # TB payload bits (before TB CRC)
    c: int              # number of codeblocks
    zc: int
    k: int              # codeblock size (message bits incl. fillers)
    k_prime: int        # message bits incl. CRCs, excl. fillers
    tb_crc: str         # 'crc24a' (A > 3824) or 'crc16'
    cb_crc: bool        # CRC24B attached per codeblock iff C > 1
    e: tuple[int, ...]  # per-codeblock rate-matched lengths


@cached_build
def get_segment_plan(a: int, bg: int, g_total: int, qm: int,
                     nof_layers: int = 1) -> SegmentPlan:
    """Parameters for payload size ``a`` and total rate-matched bits
    ``g_total`` over ``nof_layers`` layers with modulation order ``qm``."""
    tb_crc = "crc24a" if a > 3824 else "crc16"
    b = a + (24 if tb_crc == "crc24a" else 16)

    max_k = MAX_K_CB[bg]
    if b <= max_k:
        c, b_prime = 1, b
    else:
        c = -(-b // (max_k - 24))
        b_prime = b + c * 24
    if b_prime % c:
        raise ValueError(f"per-CB size not integral: B'={b_prime}, C={c}")
    k_prime = b_prime // c

    if bg == BG1:
        kb = 22
    elif b > 640:   # TS 38.212 §5.2.2 BG2 Kb selection on B
        kb = 10
    elif b > 560:
        kb = 9
    elif b > 192:
        kb = 8
    else:
        kb = 6
    zc = min_lifting_size(kb, k_prime)
    k = KB_MAX[bg] * zc

    # Rate-matched length split (TS 38.212 §5.4.2.1): C - gamma short, rest long.
    ql = qm * nof_layers
    gamma = (g_total // ql) % c
    e_short = ql * ((g_total // ql) // c)
    e_long = ql * (-(-(g_total // ql) // c))
    e = tuple([e_short] * (c - gamma) + [e_long] * gamma)

    return SegmentPlan(bg=bg, a=a, c=c, zc=zc, k=k, k_prime=k_prime,
                       tb_crc=tb_crc, cb_crc=c > 1, e=e)


def segment_tb(payload: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(B_tb, A) payload bits -> (B_tb * C, K) codeblock messages.

    Attaches the TB CRC, splits into C equal parts, attaches CRC24B per part
    when C > 1, zero-fills fillers.  Filler positions are [K', K).
    """
    b_tb = payload.shape[0]
    with_tb_crc = crc_attach(payload, plan.tb_crc)
    cb_payload_len = plan.k_prime - (24 if plan.cb_crc else 0)
    parts = with_tb_crc.reshape(b_tb * plan.c, cb_payload_len)
    if plan.cb_crc:
        parts = crc_attach(parts, "crc24b")
    fill = parts.new_zeros((parts.shape[0], plan.k - plan.k_prime))
    return torch.cat([parts, fill], dim=-1)


def desegment_tb(cb_bits: torch.Tensor,
                 plan: SegmentPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """(B_tb*C, K) decoded messages -> ((B_tb, A) payload, (B_tb,) crc_ok).

    Strips fillers and CRCs, reassembles the TB, checks the TB CRC.
    """
    b_tb = cb_bits.shape[0] // plan.c
    cb_payload_len = plan.k_prime - (24 if plan.cb_crc else 0)
    tb = cb_bits[:, :cb_payload_len].reshape(b_tb, plan.c * cb_payload_len)
    ok = crc_check(tb, plan.tb_crc)
    # Reject the all-zero decode: the zero word is a codeword of any linear
    # code and CRC(0) = 0, so a decoder that collapsed to zeros would
    # otherwise false-ACK garbage.  A genuinely all-zero TB costs one
    # spurious HARQ retransmission.
    ok = ok & torch.any(tb != 0, dim=1)
    return tb[:, :plan.a], ok
