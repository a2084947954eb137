"""MAC scheduler — per-slot DL grant computation with EdgeRIC overrides.

Port of ``srsran_edgeric_5g_tpu/mac/scheduler.py`` (plain Python, a copy).

Counterpart of the reference's ``lib/scheduler`` slot loop
(cell_scheduler.cpp:87 ``run_slot``) and its two UE policies —
proportional-fair (policy/scheduler_time_pf.cpp:230 ``compute_dl_prio``:
``prio = estimated_rate / avg_rate^fairness_coeff`` with an exponential
average, exp_avg_alpha = 0.01, scheduler_time_pf.h:46) and round-robin
(policy/scheduler_time_rr.cpp: rotating start index, equal per-UE RB cap) —
plus the EdgeRIC fork's real-time hooks, which are the point of the fork:

* policy recv at slot start / metrics send at slot end
  (cell_scheduler.cpp:92-96, :143-144 — here: the caller polls
  ``runtime.edgeric.EdgericAgent`` and passes the latest weights/MCS in);
* metric taps inside the policy loop (scheduler_time_pf.cpp:74-77
  ``set_cqi/set_snr/set_dl_buffer/set_ul_buffer`` — here: ``ue_reports()``);
* the weight override ``n_prbs = w * unused_crbs`` clamped by the
  data-derived PRB need and expert min/max
  (ue_cell_grid_allocator.cpp:296-305);
* the MCS override replacing link adaptation
  (ue_cell_grid_allocator.cpp:426-432).

The scheduler is deliberately host-side Python: it is control logic at
1 kHz, not compute — the reference runs it on one CPU thread inside the
slot indication.  Its grants are static-shape descriptors that feed the
PHY on the card (``models.hetero_cell.HeteroCellProcessor`` for arbitrary
allocations, built once per grant layout).
"""

from __future__ import annotations

import dataclasses

from ..ran import tbs as tbs_mod

# TS 38.214 Table 5.2.2.1-2 (4-bit CQI, 64QAM table): spectral efficiency
# per CQI index (index 0 = out of range).  The reference's link adaptation
# (link_adaptation_controller) selects the highest MCS whose efficiency does
# not exceed the reported CQI's.
CQI_EFFICIENCY = (
    0.0, 0.1523, 0.2344, 0.3770, 0.6016, 0.8770, 1.1758, 1.4766,
    1.9141, 2.4063, 2.7305, 3.3223, 3.9023, 4.5234, 5.1152, 5.5547,
)

N_SC_PER_PRB = 12


def mcs_from_cqi(cqi: int, table: str = "qam64") -> int | None:
    """CQI index -> highest MCS whose spectral efficiency <= the CQI's.

    Returns None for CQI 0 (out of range — no allocation, the same bail-out
    as calculate_dl_mcs returning nullopt, scheduler_time_pf.cpp:~290).
    """
    if cqi <= 0:
        return None
    cqi = min(cqi, 15)
    target = CQI_EFFICIENCY[cqi]
    best = None
    for idx in range(32):
        try:
            m = tbs_mod.mcs_config(idx, table)
        except (ValueError, IndexError):
            break
        if m.qm * m.target_rate <= target + 1e-9:
            best = idx
    return best if best is not None else 0


def prbs_for_bytes(nof_bytes: int, mcs: tbs_mod.McsConfig, nof_symbols: int,
                   nof_dmrs_re_per_prb: int, max_prbs: int) -> int:
    """Smallest PRB count whose TBS carries ``nof_bytes`` (the allocator's
    ``calc_prbs``); TBS is monotone in n_prb so a linear scan suffices at
    these bandwidths.  Returns ``max_prbs`` when the buffer exceeds one
    slot's capacity."""
    need = 8 * nof_bytes
    for n in range(1, max_prbs + 1):
        if tbs_mod.tbs_for_alloc(n, nof_symbols, nof_dmrs_re_per_prb,
                                 mcs) >= need:
            return n
    return max_prbs


def rbg_size_for_bwp(nof_prb: int, config: int = 1) -> int:
    """Nominal RBG size P, TS 38.214 Table 5.1.2.2.1-1."""
    bounds = ((36, 2, 4), (72, 4, 8), (144, 8, 16), (275, 16, 16))
    for hi, p1, p2 in bounds:
        if nof_prb <= hi:
            return p1 if config == 1 else p2
    raise ValueError(nof_prb)


@dataclasses.dataclass
class SchedUe:
    """Per-UE scheduler context (the PF ``ue_ctxt`` + metric-tap state)."""

    rnti: int
    cqi: int = 15
    snr_db: float = 30.0
    dl_buffer: int = 0          # pending DL new-tx bytes
    ul_buffer: int = 0
    # PF exponential-average throughput state (scheduler_time_pf.cpp:385-404:
    # plain average for the first 1/alpha samples, then exponential).
    dl_avg_rate: float = 0.0
    dl_nof_samples: int = 0
    ul_avg_rate: float = 0.0
    ul_nof_samples: int = 0
    tx_bytes: float = 0.0       # cumulative, for the EdgeRIC report
    rx_bytes: float = 0.0
    # Last applied MCS (link-adaptation hysteresis state; None = none yet).
    applied_mcs: int | None = None
    # HARQ entities (harq_entity per UE, ue.h): retransmission state for
    # the CRC-NACK -> retx-grant -> soft-combined-decode control loop.
    ul_harq: "HarqEntity" = None    # type: ignore[assignment]
    dl_harq: "HarqEntity" = None    # type: ignore[assignment]

    def __post_init__(self):
        if self.ul_harq is None:
            self.ul_harq = HarqEntity()
        if self.dl_harq is None:
            self.dl_harq = HarqEntity()

    def save_dl_alloc(self, alloc_bytes: int, alpha: float) -> None:
        if self.dl_nof_samples < 1.0 / alpha:
            self.dl_avg_rate += ((alloc_bytes - self.dl_avg_rate)
                                 / (self.dl_nof_samples + 1))
        else:
            self.dl_avg_rate = ((1 - alpha) * self.dl_avg_rate
                                + alpha * alloc_bytes)
        self.dl_nof_samples += 1
        self.tx_bytes += alloc_bytes

    def save_ul_alloc(self, alloc_bytes: int, alpha: float) -> None:
        """The UL mirror (scheduler_time_pf.cpp:397-404)."""
        if self.ul_nof_samples < 1.0 / alpha:
            self.ul_avg_rate += ((alloc_bytes - self.ul_avg_rate)
                                 / (self.ul_nof_samples + 1))
        else:
            self.ul_avg_rate = ((1 - alpha) * self.ul_avg_rate
                                + alpha * alloc_bytes)
        self.ul_nof_samples += 1
        self.rx_bytes += alloc_bytes


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Expert config (scheduler_expert_config.h + the zmq-mode YAML)."""

    nof_prb: int                       # BWP size (52 @10 MHz, 106 @20 MHz)
    nof_symbols: int = 12              # PDSCH time span
    # 2 full DM-RS symbols with no data sharing (2 CDM groups without data,
    # the PHY layout PdschConfig.derived_tbs assumes): 24 REs/PRB.
    nof_dmrs_re_per_prb: int = 24
    policy: str = "time_pf"            # or "time_rr"
    fairness_coeff: float = 1.5        # pf_sched_fairness_coeff (zmq yml:39)
    exp_avg_alpha: float = 0.01
    min_prbs: int = 1                  # expert_cfg.pdsch_nof_rbs.start()
    max_prbs_per_ue: int | None = None  # .stop(); None = whole BWP
    mcs_table: str = "qam64"
    # Resource-block-group granularity (TS 38.214 Table 5.1.2.2.1-1,
    # config 1): grants snap to RBG multiples.  Besides spec fidelity this
    # bounds the distinct allocation layouts, so the per-layout hetero-PHY
    # processors cache instead of being rebuilt per TTI (bucket-and-pad).
    rbg_size: int = 1
    # Link-adaptation hysteresis: keep a UE's applied MCS until the
    # CQI-derived MCS moves by at least this many indices.  0 = off
    # (instant tracking).  Standard LA practice, and on this framework it
    # also bounds grant-layout churn — every MCS flip is a new PHY layout
    # (76 layouts in 5000 PF slots at 0, 18 at 2, in the reference's churn
    # study).
    mcs_hysteresis: int = 0


@dataclasses.dataclass(frozen=True)
class DlGrant:
    """One UE's PDSCH allocation for this slot — maps 1:1 onto
    models.pdsch.PdschConfig(start_prb, nof_prb, modulation, target_rate).

    ``pid``/``rv``/``is_retx`` carry the HARQ context: a retransmission
    grant reuses the original process's PRB count and MCS (the TBS must not
    change across retransmissions — ue_cell_grid_allocator.cpp retx
    allocation keeps h_dl.last_alloc_params) at the next redundancy
    version of the 0,2,3,1 sequence."""

    rnti: int
    start_prb: int
    nof_prb: int
    mcs: int
    qm: int
    target_rate: float
    tbs: int
    pid: int = 0
    rv: int = 0
    is_retx: bool = False
    # UCI allocation for the DL grant's HARQ-ACK (filled when the cell has
    # a UciAllocator): ACK slot offset, PUCCH resource indicator (None =
    # UCI multiplexed on that slot's PUSCH), DAI bit index.
    k1: int = 0
    pucch_res: int | None = None
    harq_bit_idx: int = 0

    @property
    def modulation(self) -> str:
        return tbs_mod.McsConfig(self.qm, self.target_rate).modulation


HARQ_RV_SEQUENCE = (0, 2, 3, 1)   # rv_sequence, harq_process.h
NOF_HARQ_PROCESSES = 8
MAX_HARQ_RETX = 4                 # expert cfg max_nof_harq_retxs default


@dataclasses.dataclass
class HarqProcess:
    """One MAC HARQ process (harq_process<...> in harq_process.h): holds
    the allocation parameters of the in-flight transport block so a
    retransmission grant can be built with the identical TBS."""

    pid: int
    grant: DlGrant | None = None
    tx_count: int = 0             # transmissions already granted
    pending_retx: bool = False    # NACKed, awaiting a retx grant
    awaiting_crc: bool = False    # granted, awaiting the CRC indication
    grant_slot: int = -1          # slot of the last grant (timeout base)

    @property
    def busy(self) -> bool:
        return self.grant is not None

    def next_rv(self) -> int:
        return HARQ_RV_SEQUENCE[min(self.tx_count,
                                    len(HARQ_RV_SEQUENCE) - 1)]

    def free(self) -> None:
        self.grant = None
        self.tx_count = 0
        self.pending_retx = False
        self.awaiting_crc = False


class HarqEntity:
    """Per-UE pool of NOF_HARQ_PROCESSES (harq_entity in the reference).

    The scheduler allocates a free process for every new transmission,
    marks NACKed ones pending, and drops a TB after MAX_HARQ_RETX failed
    retransmissions (the reference discards and reports a DL/UL HARQ
    failure to RLC)."""

    #: Slots to wait for a CRC indication before a process self-frees
    #: (the reference's ack_wait_timeout: a lost indication must not leak
    #: the process forever — callers that never report CRC, e.g. plain
    #: policy simulations, keep working).
    CRC_TIMEOUT_SLOTS = 8

    def __init__(self):
        self.procs = [HarqProcess(pid=i) for i in range(NOF_HARQ_PROCESSES)]
        self.nof_dropped = 0      # TBs abandoned at max retx

    def find_free(self) -> HarqProcess | None:
        for p in self.procs:
            if not p.busy:
                return p
        return None

    def pending_retx(self) -> list[HarqProcess]:
        return [p for p in self.procs if p.pending_retx]

    def expire(self, slot: int) -> None:
        """Timeout processes whose CRC indication never arrived."""
        for p in self.procs:
            if (p.awaiting_crc and not p.pending_retx
                    and slot - p.grant_slot > self.CRC_TIMEOUT_SLOTS):
                p.free()

    def on_crc(self, pid: int, ok: bool) -> None:
        p = self.procs[pid % NOF_HARQ_PROCESSES]
        if not p.busy:
            return
        p.awaiting_crc = False
        if ok:
            p.free()
        elif p.tx_count > MAX_HARQ_RETX:
            p.free()
            self.nof_dropped += 1
        else:
            p.pending_retx = True


class CellScheduler:
    """Slot-driven DL scheduler for one cell.

    Usage per TTI (the cell_scheduler::run_slot sequence):
        weights = agent.get_weights(rntis)   # EdgeRIC recv (fail-open None)
        mcs     = agent.get_mcs(rntis)
        grants  = sched.run_slot(weights=weights, mcs_overrides=mcs)
        agent.send_metrics(sched.ue_reports())   # EdgeRIC send
    """

    def __init__(self, cfg: SchedulerConfig, rntis: list[int],
                 uci_allocator=None):
        self.cfg = cfg
        self.ues = {r: SchedUe(rnti=r) for r in rntis}
        self._rr_next = 0
        self.slot = 0
        self._ul_slot = 0
        # Optional mac.uci_allocator.UciAllocator: when present, every DL
        # grant gets its HARQ-ACK opportunity allocated (k1 + PUCCH
        # resource indicator or UCI-on-PUSCH) and UL grants register their
        # PUSCH so later ACKs multiplex onto it —
        # uci_allocator_impl.cpp:alloc_uci_harq_ue.
        self.uci = uci_allocator
        # Auto-ACK until the caller proves it plumbs CRC/ACK indications
        # (the reference's mac_test_mode_adapter auto-acks HARQ for
        # test-mode UEs): policy-only users never strand processes.
        self._crc_seen = {"ul": False, "dl": False}

    # ---- HARQ indications (cell_scheduler.cpp:60 handle_crc_indication /
    # handle_uci_indication -> harq ack) ----

    def enable_harq(self) -> None:
        """Declare that CRC/ACK indications WILL be plumbed: disables the
        test-mode auto-ACK so processes are held from the first grant on
        (callers that report CRCs arm this implicitly, but only after
        their first indication — call this up front to track the very
        first TBs too)."""
        self._crc_seen["ul"] = self._crc_seen["dl"] = True

    def handle_crc_indication(self, rnti: int, pid: int, ok: bool) -> None:
        """UL CRC result for (rnti, pid): ACK frees the process, NACK marks
        it pending — the next ``run_slot_ul`` emits a retransmission grant
        with identical TBS at the next rv of the 0,2,3,1 sequence."""
        self._crc_seen["ul"] = True
        if rnti in self.ues:
            self.ues[rnti].ul_harq.on_crc(pid, ok)

    def handle_dl_ack(self, rnti: int, pid: int, ack: bool) -> None:
        """DL HARQ-ACK (PUCCH UCI path): same contract for the DL entity."""
        self._crc_seen["dl"] = True
        if rnti in self.ues:
            self.ues[rnti].dl_harq.on_crc(pid, ack)

    # ---- feedback handlers (the MAC indication plumbing) ----

    def update_buffer(self, rnti: int, dl_bytes: int | None = None,
                      ul_bytes: int | None = None) -> None:
        u = self.ues[rnti]
        if dl_bytes is not None:
            u.dl_buffer = dl_bytes
        if ul_bytes is not None:
            u.ul_buffer = ul_bytes

    def handle_csi(self, rnti: int, cqi: int,
                   snr_db: float | None = None) -> None:
        u = self.ues[rnti]
        u.cqi = cqi
        if snr_db is not None:
            u.snr_db = snr_db

    # ---- the per-slot scheduling pass ----

    def run_slot(self, weights: dict[int, float] | None = None,
                 mcs_overrides: dict[int, int] | None = None
                 ) -> list[DlGrant]:
        """Compute this slot's DL grants.

        ``weights``/``mcs_overrides``: the EdgeRIC policies (None = fail-open,
        default policy decides everything — edgeric.cpp:289-295).
        """
        grants = self._run_pass("dl", weights, mcs_overrides)
        if self.uci is not None:
            self.uci.slot_indication(self.slot)
            alloc_grants = []
            for g in grants:
                a = self.uci.alloc_harq_ack(self.slot, g.rnti)
                if a is None:
                    # No UCI opportunity for the ACK -> the grant cannot be
                    # scheduled this slot (the reference drops the PDSCH
                    # allocation when alloc_uci_harq_ue fails,
                    # ue_cell_grid_allocator.cpp).  A new tx releases its
                    # HARQ process; a retx goes back to pending for the
                    # next slot's retx-first pass.
                    p = self.ues[g.rnti].dl_harq.procs[g.pid]
                    if g.is_retx:
                        p.pending_retx = True
                    else:
                        p.free()
                    continue
                alloc_grants.append(dataclasses.replace(
                    g, k1=a.k1, pucch_res=a.pucch_res_indicator,
                    harq_bit_idx=a.harq_bit_idx))
            grants = alloc_grants
        self.slot += 1
        return grants

    def run_slot_ul(self) -> list[DlGrant]:
        """The UL scheduling pass (scheduler_time_pf.cpp ul_sched /
        scheduler_time_rr ul counterpart): same policies over ul_buffer with
        the UL average-rate history.  The EdgeRIC overrides are DL-side
        hooks in the reference, so none apply here.

        Pending HARQ retransmissions are allocated FIRST, before any new
        transmission (ue_cell_grid_allocator retx-before-newtx ordering):
        a retx grant keeps the original PRB count / MCS / TBS and advances
        the redundancy version."""
        grants = self._run_pass("ul", None, None)
        if self.uci is not None:
            # Register the PUSCH grants so HARQ-ACK/CSI landing on this
            # slot multiplexes onto the PUSCH instead of claiming a PUCCH
            # resource (multiplex_uci_on_pusch).
            for g in grants:
                self.uci.on_pusch_grant(self._ul_slot, g.rnti)
        self._ul_slot += 1
        return grants

    def _alloc_retx(self, d: str, order, next_prb: int,
                    grants: list[DlGrant]) -> int:
        """Allocate pending retransmissions front-of-queue; returns the
        advanced PRB cursor."""
        cfg = self.cfg
        slot = self._ul_slot if d == "ul" else self.slot
        for rnti in order:
            ent = (self.ues[rnti].ul_harq if d == "ul"
                   else self.ues[rnti].dl_harq)
            ent.expire(slot)
            for p in ent.pending_retx():
                g0 = p.grant
                if cfg.nof_prb - next_prb < g0.nof_prb:
                    continue      # does not fit this slot; stays pending
                g = dataclasses.replace(g0, start_prb=next_prb,
                                        rv=p.next_rv(), is_retx=True)
                grants.append(g)
                p.grant = g
                p.tx_count += 1
                p.pending_retx = False
                p.awaiting_crc = True
                p.grant_slot = slot
                next_prb += g.nof_prb
        return next_prb

    def _run_pass(self, d: str, weights, mcs_overrides) -> list[DlGrant]:
        cfg = self.cfg
        buf = (lambda u: u.dl_buffer) if d == "dl" else (lambda u: u.ul_buffer)
        order = self._ue_order(d)
        grants: list[DlGrant] = []
        next_prb = self._alloc_retx(d, order, 0, grants)
        unused_crbs = cfg.nof_prb  # this_tti_unused_crbs at policy start
        retx_rntis = {g.rnti for g in grants}
        for rnti in order:
            u = self.ues[rnti]
            remaining = cfg.nof_prb - next_prb
            # One PUSCH/PDSCH per UE per slot: a retx consumed this UE's
            # occasion.  New tx also needs a free HARQ process.
            if remaining <= 0 or buf(u) <= 0 or rnti in retx_rntis:
                continue
            harq = (u.ul_harq if d == "ul" else u.dl_harq).find_free()
            if harq is None:
                continue
            # --- MCS: link adaptation, unless EdgeRIC overrides
            # (ue_cell_grid_allocator.cpp:426-432). ---
            mcs_idx = mcs_from_cqi(u.cqi, cfg.mcs_table)
            if (cfg.mcs_hysteresis > 0 and mcs_idx is not None
                    and u.applied_mcs is not None
                    and abs(mcs_idx - u.applied_mcs) < cfg.mcs_hysteresis):
                mcs_idx = u.applied_mcs
            if mcs_overrides and rnti in mcs_overrides:
                mcs_idx = int(mcs_overrides[rnti])
            if mcs_idx is None:
                continue
            u.applied_mcs = mcs_idx
            try:
                mcs = tbs_mod.mcs_config(mcs_idx, cfg.mcs_table)
            except ValueError:       # reserved entry requested: skip UE
                continue
            # --- PRB count: data-derived need (calc_prbs), policy split,
            # then the EdgeRIC weight override. ---
            cap = remaining
            if cfg.max_prbs_per_ue is not None:
                cap = min(cap, cfg.max_prbs_per_ue)
            calc_prbs = prbs_for_bytes(buf(u), mcs, cfg.nof_symbols,
                                       cfg.nof_dmrs_re_per_prb, cap)
            if cfg.policy == "time_rr" and (weights is None
                                            or rnti not in weights):
                # equal split among backlogged UEs (rr: per-UE RB cap =
                # remaining / n, compute_max_nof_rbs_per_ue_per_slot).
                backlogged = sum(1 for x in self.ues.values()
                                 if buf(x) > 0)
                calc_prbs = min(calc_prbs,
                                max(1, cfg.nof_prb // max(backlogged, 1)))
            n_prbs = min(calc_prbs, cap)
            if weights is not None and rnti in weights:
                # n_prbs = w * unused_crbs, clamped by calc_prbs and the
                # expert limits (ue_cell_grid_allocator.cpp:296-305).
                n_prbs = int(weights[rnti] * unused_crbs)
                n_prbs = min(n_prbs, calc_prbs)
                n_prbs = max(n_prbs, cfg.min_prbs)
                if cfg.max_prbs_per_ue is not None:
                    n_prbs = min(n_prbs, cfg.max_prbs_per_ue)
                n_prbs = min(n_prbs, remaining)
            if n_prbs <= 0:
                continue
            if cfg.rbg_size > 1:   # snap up to the RBG grid, cap at the BWP
                n_prbs = min(-(-n_prbs // cfg.rbg_size) * cfg.rbg_size,
                             remaining)
            tb = tbs_mod.tbs_for_alloc(n_prbs, cfg.nof_symbols,
                                       cfg.nof_dmrs_re_per_prb, mcs)
            g = DlGrant(rnti=rnti, start_prb=next_prb, nof_prb=n_prbs,
                        mcs=mcs_idx, qm=mcs.qm,
                        target_rate=mcs.target_rate, tbs=tb,
                        pid=harq.pid, rv=0)
            grants.append(g)
            harq.grant = g
            harq.tx_count = 1
            harq.awaiting_crc = True
            harq.grant_slot = self._ul_slot if d == "ul" else self.slot
            if not self._crc_seen[d]:
                harq.free()     # test-mode auto-ACK (no indications wired)
            next_prb += n_prbs
            alloc_bytes = tb // 8
            if d == "dl":
                u.save_dl_alloc(alloc_bytes, cfg.exp_avg_alpha)
                u.dl_buffer = max(0, u.dl_buffer - alloc_bytes)
            else:
                u.save_ul_alloc(alloc_bytes, cfg.exp_avg_alpha)
                u.ul_buffer = max(0, u.ul_buffer - alloc_bytes)
        # UEs that got nothing still roll their PF average forward with 0
        # (save_dl_alloc(alloc_result.alloc_bytes) runs for every queue pop).
        granted = {g.rnti for g in grants}
        for rnti, u in self.ues.items():
            if rnti not in granted:
                (u.save_dl_alloc if d == "dl"
                 else u.save_ul_alloc)(0, cfg.exp_avg_alpha)
        return grants

    def _ue_order(self, d: str = "dl") -> list[int]:
        rntis = list(self.ues)
        if self.cfg.policy == "time_rr":
            # rotating start index (scheduler_time_rr round_robin_apply).
            k = self._rr_next % len(rntis)
            self._rr_next += 1
            return rntis[k:] + rntis[:k]
        # time_pf: prio = estimated_rate / avg_rate^coeff
        # (scheduler_time_pf.cpp:295-299; rate estimated at the maximum
        # time-domain span over the full BWP, like compute_dl_prio's
        # "estimate of instantaneous achievable rate").
        prios = []
        for rnti, u in self.ues.items():
            mcs_idx = mcs_from_cqi(u.cqi, self.cfg.mcs_table)
            pending = u.dl_buffer if d == "dl" else u.ul_buffer
            if mcs_idx is None or pending <= 0:
                prios.append((0.0, rnti))
                continue
            mcs = tbs_mod.mcs_config(mcs_idx, self.cfg.mcs_table)
            est = tbs_mod.tbs_for_alloc(self.cfg.nof_prb, self.cfg.nof_symbols,
                                        self.cfg.nof_dmrs_re_per_prb, mcs) / 8
            avg = u.dl_avg_rate if d == "dl" else u.ul_avg_rate
            if avg > 0:
                p = est / (avg ** self.cfg.fairness_coeff)
            else:
                p = float("inf") if est > 0 else 0.0
            prios.append((p, rnti))
        prios.sort(key=lambda t: (-t[0], t[1]))
        return [r for _, r in prios]

    # ---- EdgeRIC metric taps out (scheduler_time_pf.cpp:74-77 set_*,
    # ue_event_manager.cpp:351,384 byte taps) ----

    def ue_reports(self):
        from ..runtime.edgeric import UeReport
        return [UeReport(rnti=u.rnti, cqi=u.cqi, snr=u.snr_db,
                         tx_bytes=u.tx_bytes, rx_bytes=u.rx_bytes,
                         dl_buffer=u.dl_buffer, ul_buffer=u.ul_buffer,
                         dl_tbs=8.0 * u.dl_avg_rate)
                for u in self.ues.values()]

    # ---- PHY hand-off ----

    def to_pdsch_configs(self, grants: list[DlGrant], slot: int = 0,
                         **kw) -> list:
        """Grants -> models.pdsch.PdschConfig list for HeteroCellProcessor."""
        from ..models.pdsch import PdschConfig
        return [PdschConfig(rnti=g.rnti, nof_prb=g.nof_prb,
                            start_prb=g.start_prb, modulation=g.modulation,
                            target_rate=g.target_rate, slot=slot, **kw)
                for g in grants]
