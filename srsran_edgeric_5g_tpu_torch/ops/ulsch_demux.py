"""UL-SCH multiplexing / demultiplexing: UCI piggybacked on PUSCH.

Port of ``srsran_edgeric_5g_tpu/ops/ulsch_demux.py`` (TS 38.212 §6.2.7, the
reference's ulsch_demultiplex_impl.cpp): coded HARQ-ACK and CSI bits occupy
REs inside the PUSCH allocation, and the receive side splits the equalised
LLR stream into SCH and UCI branches.

The placement plan is host numpy, a line-for-line copy of the reference's
(position order is bit-level):

  * HARQ-ACK REs: walking data symbols from l1 (the first symbol after the
    first DM-RS symbol), each symbol takes take = min(M, remaining) REs at
    stride d = floor(M / take): RE indices j*d.
  * CSI part 1: the same walk from l1_csi (the first data symbol), over the
    symbol's REs excluding the ACK REs and the reserved REs.
  * CSI part 2: the same walk over the REs excluding ACK and CSI part 1,
    but not the reserved REs.
  * O_ack > 2 (or no reserved REs): the SCH stream skips the UCI REs (the
    UL-SCH is rate-matched to G_sch = G - G_ack - G_csi1 - G_csi2).
  * O_ack <= 2 with reserved REs: the SCH maps through every non-CSI
    position, and the ACK punctures the subset reserved[j*floor(n_rvd/n_ack)],
    which the receiver zeroes (erasures) in whichever stream holds it.

Multiplexing is static scatters and demultiplexing static gathers (+ the
erasure zeroing of the reserved mode), with the plan's index tensors built
once per device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


# eq=False: plans are cached per key, so identity is equality (the index
# arrays keep a generated __eq__ from working).
@dataclasses.dataclass(frozen=True, eq=False)
class UlschDemuxPlan:
    g_total: int
    qm: int
    ack_positions: np.ndarray    # (G_ack,) bit positions in the G stream
    csi1_positions: np.ndarray   # (G_csi1,)
    csi2_positions: np.ndarray   # (G_csi2,)
    csi2_erased: np.ndarray      # bool (G_csi2,) True where ACK punctured
    sch_positions: np.ndarray    # (G_sch,) stream positions carrying SCH
    sch_erased: np.ndarray       # bool (G_sch,) True where ACK punctured
    key: tuple

    @property
    def sch_len(self) -> int:
        return len(self.sch_positions)


def _place_res(data_symbols: tuple[int, ...], m: int, first_symbol: int,
               n_re: int, excluded: set[int]) -> list[int]:
    """§6.2.7 per-symbol distribution -> stream RE indices (ascending)."""
    out = []
    need = n_re
    for s, l in enumerate(data_symbols):
        if l < first_symbol or need <= 0:
            continue
        avail = [r for r in range(m) if s * m + r not in excluded]
        if not avail:
            continue
        take = min(len(avail), need)
        d = len(avail) // take
        out.extend(s * m + avail[j * d] for j in range(take))
        need -= take
    if need != 0:
        raise ValueError("allocation cannot hold the UCI payload")
    return out


@functools.lru_cache(maxsize=None)
def get_demux_plan(g_total: int, qm: int, re_per_symbol: int,
                   data_symbols: tuple[int, ...],
                   first_dmrs_symbol: int,
                   g_ack: int = 0, g_csi1: int = 0,
                   g_ack_rvd: int = 0, o_ack: int = 3,
                   g_csi2: int = 0) -> UlschDemuxPlan:
    """Build the §6.2.7 placement plan.

    ``re_per_symbol``: data REs per symbol in the allocation; the G stream is
    frequency-first within each symbol (the PUSCH mapper's order).
    ``o_ack``: HARQ-ACK payload bits; <= 2 with ``g_ack_rvd`` > 0 selects
    the reserved / puncture mode."""
    m = re_per_symbol
    if g_total != qm * m * len(data_symbols):
        raise ValueError(f"G = {g_total} is not Qm * REs of the data symbols")
    if g_ack % qm or g_csi1 % qm or g_ack_rvd % qm or g_csi2 % qm:
        raise ValueError("every UCI bit count must be a multiple of Qm")

    def bits(res):
        r = np.asarray(sorted(res), dtype=np.int64)
        return (r[:, None] * qm + np.arange(qm)[None]).reshape(-1)

    # l1: the first data symbol after the first DM-RS symbol.
    l1 = next(l for l in data_symbols if l > first_dmrs_symbol)
    l1_csi = data_symbols[0]

    reserved_mode = (o_ack <= 2) and g_ack_rvd > 0
    if reserved_mode:
        rvd_res = _place_res(data_symbols, m, l1, g_ack_rvd // qm, set())
        n_ack_re = g_ack // qm
        if n_ack_re:
            d = len(rvd_res) // n_ack_re
            ack_res = [sorted(rvd_res)[j * d] for j in range(n_ack_re)]
        else:
            ack_res = []
        # CSI part 1 avoids the reserved REs; CSI part 2 does not (it only
        # avoids REs already removed from the UCI set: DM-RS and CSI1).
        csi_res = _place_res(data_symbols, m, l1_csi, g_csi1 // qm,
                             set(rvd_res)) if g_csi1 else []
        csi2_res = _place_res(data_symbols, m, l1_csi, g_csi2 // qm,
                              set(csi_res)) if g_csi2 else []
        ack_pos = bits(ack_res)
        csi_pos = bits(csi_res)
        csi2_pos = bits(csi2_res)
        # SCH maps through everything except CSI1/CSI2; the ACK punctures
        # (erases) whichever stream holds each reserved position.
        keep = np.ones(g_total, dtype=bool)
        if len(csi_pos):
            keep[csi_pos] = False
        if len(csi2_pos):
            keep[csi2_pos] = False
        sch_positions = np.flatnonzero(keep).astype(np.int64)
        erased = np.zeros(g_total, dtype=bool)
        erased[ack_pos] = True
        sch_erased = erased[sch_positions]
        csi2_erased = erased[csi2_pos] if len(csi2_pos) \
            else np.zeros(0, dtype=bool)
    else:
        ack_res = _place_res(data_symbols, m, l1, g_ack // qm, set()) \
            if g_ack else []
        csi_res = _place_res(data_symbols, m, l1_csi, g_csi1 // qm,
                             set(ack_res)) if g_csi1 else []
        csi2_res = _place_res(data_symbols, m, l1_csi, g_csi2 // qm,
                              set(ack_res) | set(csi_res)) if g_csi2 else []
        ack_pos = bits(ack_res)
        csi_pos = bits(csi_res)
        csi2_pos = bits(csi2_res)
        keep = np.ones(g_total, dtype=bool)
        for pos in (ack_pos, csi_pos, csi2_pos):
            if len(pos):
                keep[pos] = False
        sch_positions = np.flatnonzero(keep).astype(np.int64)
        sch_erased = np.zeros(len(sch_positions), dtype=bool)
        csi2_erased = np.zeros(len(csi2_pos), dtype=bool)

    return UlschDemuxPlan(g_total=g_total, qm=qm,
                          ack_positions=ack_pos, csi1_positions=csi_pos,
                          csi2_positions=csi2_pos, csi2_erased=csi2_erased,
                          sch_positions=sch_positions, sch_erased=sch_erased,
                          key=(g_total, qm, re_per_symbol, data_symbols,
                               first_dmrs_symbol, g_ack, g_csi1, g_ack_rvd,
                               o_ack, g_csi2))


@dataclasses.dataclass(frozen=True, eq=False)
class _PlanTensors:
    ack: torch.Tensor
    csi1: torch.Tensor
    csi2: torch.Tensor
    sch: torch.Tensor
    csi2_erased: torch.Tensor | None   # None: nothing erased
    sch_erased: torch.Tensor | None


@functools.lru_cache(maxsize=None)
def _tensors(plan: UlschDemuxPlan, device: torch.device) -> _PlanTensors:
    def on(a):
        return torch.as_tensor(a, device=device)
    return _PlanTensors(
        ack=on(plan.ack_positions), csi1=on(plan.csi1_positions),
        csi2=on(plan.csi2_positions), sch=on(plan.sch_positions),
        csi2_erased=on(plan.csi2_erased) if plan.csi2_erased.any() else None,
        sch_erased=on(plan.sch_erased) if plan.sch_erased.any() else None)


def multiplex(sch_bits: torch.Tensor, plan: UlschDemuxPlan,
              ack_bits: torch.Tensor | None = None,
              csi1_bits: torch.Tensor | None = None,
              csi2_bits: torch.Tensor | None = None) -> torch.Tensor:
    """(B, G_sch) SCH bits + UCI bits -> the (B, G) transmitted stream.

    In the skip mode G_sch = G - G_uci and the SCH scatters around the UCI;
    in the reserved mode G_sch covers the reserved REs too and the ACK
    overwrites (punctures) its subset afterwards."""
    pt = _tensors(plan, sch_bits.device)
    out = sch_bits.new_zeros((sch_bits.shape[0], plan.g_total))
    out[:, pt.sch] = sch_bits
    if csi1_bits is not None and len(plan.csi1_positions):
        out[:, pt.csi1] = csi1_bits.to(out.dtype)
    if csi2_bits is not None and len(plan.csi2_positions):
        out[:, pt.csi2] = csi2_bits.to(out.dtype)
    # ACK last: in the reserved mode it punctures SCH / CSI2 positions.
    if ack_bits is not None and len(plan.ack_positions):
        out[:, pt.ack] = ack_bits.to(out.dtype)
    return out


def demultiplex(llrs: torch.Tensor, plan: UlschDemuxPlan):
    """(B, G) LLRs -> ((B, G_sch) sch_llrs float32, ack_llrs, csi1_llrs,
    csi2_llrs).  Reserved-mode ACK-punctured SCH / CSI2 positions become
    LLR 0 (erasures)."""
    pt = _tensors(plan, llrs.device)
    ack = llrs[:, pt.ack]
    csi = llrs[:, pt.csi1]
    csi2 = llrs[:, pt.csi2]
    if pt.csi2_erased is not None:
        csi2 = torch.where(pt.csi2_erased, 0.0, csi2.to(torch.float32))
    sch = llrs[:, pt.sch].to(torch.float32)
    if pt.sch_erased is not None:
        sch = torch.where(pt.sch_erased, 0.0, sch)
    return sch, ack, csi, csi2
