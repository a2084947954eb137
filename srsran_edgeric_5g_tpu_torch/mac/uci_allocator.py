"""UCI allocator: decides WHERE each UE's HARQ-ACK / SR / CSI lands.

Port of ``srsran_edgeric_5g_tpu/mac/uci_allocator.py`` (plain Python, a
copy).  Counterpart of the reference's uci_allocator_impl
(lib/scheduler/uci_scheduling/uci_allocator_impl.cpp) + the PUCCH resource
indicator assignment half of pucch_allocator_impl.  The reference decides,
per DL grant, on which UL slot (k1 out of dl-data-to-ul-ack candidates) and
which PUCCH resource the HARQ-ACK rides — or moves the bits onto an
existing PUSCH grant (UCI-on-PUSCH multiplexing).  This module reproduces
that allocation logic as plain host-side control code; the PHY side stays
STATIC (parallel/full_cell.py maps a fixed F1/F2 resource set into the grid
every slot), and the allocator assigns indicators WITHIN that static set —
dynamic selection in MAC, static shapes on the device.

Reference behaviors kept (uci_allocator_impl.cpp):
  * k1 candidate walk in list order, skipping non-UL slots and slots whose
    UCI list is full (alloc_uci_harq_ue, :212-263).
  * TS 38.214 §5.1 ordering: the ACK slot may not precede an already-
    assigned ACK slot of an earlier PDSCH — implemented as the reference
    does via get_min_pdsch_to_ack_slot_distance (:114-129): prefer the
    LARGEST k1 whose UCI slot already carries this UE's UCI, and never go
    below it.
  * A UE with a PUSCH grant on the ACK slot gets NO PUCCH resource — the
    bits are multiplexed onto the PUSCH (alloc_uci_harq_ue_helper :146-150,
    multiplex_uci_on_pusch :270-297).
  * DAI / harq_bit_idx: per-(slot, UE) scheduled-PDSCH counter (:246-253).
  * SR / CSI opportunities are skipped / moved to PUSCH when a PUSCH grant
    exists (uci_allocate_sr_opportunity :299-317, csi :319-345).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict


@dataclasses.dataclass(frozen=True)
class PucchResource:
    """One entry of the cell's PUCCH resource set (pucch_resource,
    ran/pucch/pucch_configuration.h).  F1 resources are distinguished by
    (prb, initial cyclic shift, time-domain OCC); F2 by (prb, symbols)."""

    res_id: int
    format: int                 # 1 (HARQ-ACK/SR, <=2 bits) or 2 (CSI/long)
    prb: int
    initial_cyclic_shift: int = 0
    time_domain_occ: int = 0
    start_symbol: int = 0
    nof_symbols: int = 14


def default_resource_set(nof_f1: int = 8, nof_f2: int = 8,
                         f1_prb: int = 0, f2_prb0: int = 1
                         ) -> list[PucchResource]:
    """The default cell resource list (pucch_default_resource.h shape): F1
    resources sharing one PRB, separated by cyclic shift (step 3: 4 CS x 2
    OCC covers 8), then per-resource F2 PRBs."""
    res = []
    for i in range(nof_f1):
        res.append(PucchResource(res_id=i, format=1, prb=f1_prb,
                                 initial_cyclic_shift=(3 * i) % 12,
                                 time_domain_occ=i // 4))
    for i in range(nof_f2):
        res.append(PucchResource(res_id=nof_f1 + i, format=2,
                                 prb=f2_prb0 + i, start_symbol=12,
                                 nof_symbols=2))
    return res


@dataclasses.dataclass(frozen=True)
class UciAllocation:
    """Result of an allocation (uci_allocation, uci_allocator.h:28-40)."""

    k1: int
    pucch_res_indicator: int | None   # None => UCI multiplexed on PUSCH
    harq_bit_idx: int                 # DAI within this UE's UCI that slot
    on_pusch: bool = False


@dataclasses.dataclass
class _UeUci:
    """Per-(slot, UE) UCI record (slot_alloc_list::ue_uci)."""

    res_indicator: int | None = None
    harq_bits: int = 0                # scheduled_dl_pdcch_counter
    sr: bool = False
    csi_bits: int = 0
    on_pusch: bool = False


class UciAllocator:
    """Slot-grid UCI allocator.  All state is host-side Python keyed by
    absolute slot number; ``slot_indication`` garbage-collects the past
    (uci_allocator_impl::slot_indication)."""

    MAX_UCIS_PER_SLOT = 64            # slot_alloc_list.ucis capacity

    def __init__(self, resources: list[PucchResource] | None = None,
                 is_ul_slot=None):
        self.resources = resources or default_resource_set()
        self._f1 = [r for r in self.resources if r.format == 1]
        self._f2 = [r for r in self.resources if r.format == 2]
        # slot -> rnti -> _UeUci
        self._grid: dict[int, dict[int, _UeUci]] = defaultdict(dict)
        # slot -> set of claimed F1/F2 res_ids (collision-free assignment)
        self._used_f1: dict[int, set[int]] = defaultdict(set)
        self._used_f2: dict[int, set[int]] = defaultdict(set)
        # slot -> rntis holding a PUSCH grant (for UCI-on-PUSCH routing)
        self._pusch: dict[int, set[int]] = defaultdict(set)
        self._is_ul_slot = is_ul_slot or (lambda s: True)

    # ---- slot lifecycle ----

    def slot_indication(self, slot: int) -> None:
        """Drop all state strictly before ``slot``."""
        for d in (self._grid, self._used_f1, self._used_f2, self._pusch):
            for s in [s for s in d if s < slot]:
                del d[s]

    # ---- PUSCH registration (UCI-on-PUSCH multiplexing) ----

    def on_pusch_grant(self, slot: int, rnti: int) -> None:
        """A PUSCH grant exists for (slot, rnti): any UCI already placed on
        a PUCCH resource that slot moves onto the PUSCH and frees its
        resource (multiplex_uci_on_pusch); later allocations route to the
        PUSCH directly."""
        self._pusch[slot].add(rnti)
        uci = self._grid[slot].get(rnti)
        if uci is not None and not uci.on_pusch:
            if uci.res_indicator is not None:
                self._release(slot, uci.res_indicator)
                uci.res_indicator = None
            uci.on_pusch = True

    def _release(self, slot: int, res_id: int) -> None:
        self._used_f1[slot].discard(res_id)
        self._used_f2[slot].discard(res_id)

    def _claim(self, slot: int, pool, used: set[int]) -> int | None:
        for r in pool:
            if r.res_id not in used:
                used.add(r.res_id)
                return r.res_id
        return None

    # ---- HARQ-ACK ----

    def alloc_harq_ack(self, pdsch_slot: int, rnti: int,
                       k1_list=(4, 5, 6, 7)) -> UciAllocation | None:
        """Allocate the HARQ-ACK opportunity for a PDSCH at ``pdsch_slot``.

        Walks ``k1_list`` (dl-data-to-ul-ack) in order, honoring the
        TS 38.214 §5.1 monotonicity floor, and places the ACK on an
        existing PUSCH grant or a free F1 resource."""
        if not k1_list:
            return None
        # get_min_pdsch_to_ack_slot_distance: largest k1 whose slot already
        # carries this UE's UCI, else min(k1_list).
        min_k1 = min(k1_list)
        for cand in sorted(k1_list, reverse=True):
            if rnti in self._grid.get(pdsch_slot + cand, {}):
                min_k1 = cand
                break
        for k1 in k1_list:
            if k1 < min_k1:
                continue
            uci_slot = pdsch_slot + k1
            if not self._is_ul_slot(uci_slot):
                continue
            slot_ucis = self._grid[uci_slot]
            if (rnti not in slot_ucis
                    and len(slot_ucis) >= self.MAX_UCIS_PER_SLOT):
                continue
            uci = slot_ucis.get(rnti)
            if rnti in self._pusch[uci_slot]:
                # UCI-on-PUSCH (alloc skipped, bits ride the PUSCH).
                if uci is None:
                    uci = slot_ucis[rnti] = _UeUci(on_pusch=True)
                bit = uci.harq_bits
                uci.harq_bits += 1
                return UciAllocation(k1=k1, pucch_res_indicator=None,
                                     harq_bit_idx=bit, on_pusch=True)
            if uci is None:
                res = self._claim(uci_slot, self._f1, self._used_f1[uci_slot])
                if res is None:
                    continue          # no free F1 resource: next k1
                uci = slot_ucis[rnti] = _UeUci(res_indicator=res)
            bit = uci.harq_bits
            uci.harq_bits += 1
            return UciAllocation(k1=k1, pucch_res_indicator=uci.res_indicator,
                                 harq_bit_idx=bit)
        return None

    # ---- SR / CSI opportunities ----

    def alloc_sr(self, slot: int, rnti: int) -> UciAllocation | None:
        """SR opportunity: skipped entirely when a PUSCH grant exists (the
        UE has a grant — nothing to request; uci_allocate_sr_opportunity)."""
        if rnti in self._pusch[slot]:
            return None
        slot_ucis = self._grid[slot]
        uci = slot_ucis.get(rnti)
        if uci is None:
            res = self._claim(slot, self._f1, self._used_f1[slot])
            if res is None:
                return None
            uci = slot_ucis[rnti] = _UeUci(res_indicator=res)
        uci.sr = True
        return UciAllocation(k1=0, pucch_res_indicator=uci.res_indicator,
                             harq_bit_idx=uci.harq_bits)

    def alloc_csi(self, slot: int, rnti: int,
                  csi_bits: int = 4) -> UciAllocation | None:
        """CSI opportunity: on the PUSCH when one exists, else an F2
        resource (uci_allocate_csi_opportunity)."""
        slot_ucis = self._grid[slot]
        uci = slot_ucis.get(rnti)
        if rnti in self._pusch[slot]:
            if uci is None:
                uci = slot_ucis[rnti] = _UeUci(on_pusch=True)
            uci.csi_bits = csi_bits
            return UciAllocation(k1=0, pucch_res_indicator=None,
                                 harq_bit_idx=uci.harq_bits, on_pusch=True)
        res = self._claim(slot, self._f2, self._used_f2[slot])
        if res is None:
            return None
        if uci is None:
            uci = slot_ucis[rnti] = _UeUci()
        uci.csi_bits = csi_bits
        # CSI rides its own F2 resource; HARQ bits (if any) keep their F1
        # indicator — the <=2-bit-HARQ + CSI coexistence the reference's
        # current allocator supports (max_harq_bits_per_uci = 2).
        return UciAllocation(k1=0, pucch_res_indicator=res,
                             harq_bit_idx=uci.harq_bits)

    # ---- PHY occasion map ----

    def occasions(self, slot: int):
        """The slot's UCI map for the PHY: {rnti: _UeUci} — which UEs
        listen on which PUCCH resources (or carry UCI on PUSCH) this slot.
        Feed this to the full-cell program's F1/F2 occasion inputs."""
        return dict(self._grid.get(slot, {}))

    def resource(self, res_id: int) -> PucchResource:
        return self.resources[res_id]
