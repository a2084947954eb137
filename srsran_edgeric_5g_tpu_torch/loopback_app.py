"""Standalone gNB-PHY loopback app on the port: config -> cell processor ->
IQ bridge.

Port of ``tools/run_loopback_app.py``, the apps/gnb counterpart in
miniature: loads a YAML (or default) PhyConfig and runs N slots of DL ->
radio -> UL loopback on the card through the native ZMQ IQ bridge (the gNB
TX REP server looped back to the gNB RX REQ client, standing in for the GNU
Radio flowgraph and the UEs), printing per-slot metrics like the
reference's stdout plotter.

Usage:
    python -m srsran_edgeric_5g_tpu_torch.loopback_app [config.yml]
        [--slots N] [--snr dB] [--port P] [--trace FILE] [--run-ahead K]
        [--device cuda|cpu] [--sched off|rr|pf] [--edgeric] [--bcch]
        [--rach N] [--ul-traffic BYTES] [--ul-fade SLOT] [--ul-fade-snr dB]
        [--dl-fade SLOT] [--dl-fade-snr dB]

Two loops, each taking the radio as a callable, so a caller can drive it
with another radio (an in-process AWGN channel on the card, for instance):

* ``run_slot_loop`` (the default): a CellProcessor's pipelined slot loop.
  With ``--edgeric`` its metrics hub publishes every slot to an EdgeRIC
  muApp (``runtime.edgeric``).
* ``run_scheduled`` (``--sched``, and ``--rach``, ``--bcch`` or
  ``--ul-traffic``, which turn on ``pf``): MAC grants, steered per TTI by
  the RIC's weights and MCS overrides with ``--edgeric``, drive a
  HeteroCellProcessor per grant layout; HARQ-ACK and CRC indications,
  SR, BSR, the random-access procedure, SIB1 and paging run over the radio.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from .device import resolve_device
from .runtime.events import (RadioEventNotifier, SlotClock, SlotDeadline,
                             fail_open)


@dataclasses.dataclass
class LoopResult:
    nof_tbs: int            # slots * UEs
    ok_count: int           # TBs that passed CRC
    exact_count: int        # TBs that passed CRC with the sent payload
    seconds: float          # wall time of the whole loop
    latency_ms: list[float]  # per slot: UL submit -> results on the host


def run_slot_loop(proc, radio: Callable, n_slots: int,
                  payloads: Callable[[int], torch.Tensor], run_ahead: int = 2,
                  notifier: RadioEventNotifier | None = None,
                  log: Callable[[str], None] = print) -> LoopResult:
    """The app's pipelined slot loop.

    DL for up to ``run_ahead`` future slots is submitted before the current
    slot's radio round trip, and UL results are read ``depth`` (2) slots
    late — the streaming mode the reference gets from
    nof_slot_tti_in_advance and its lower-PHY executors
    (lower_phy_baseband_processor.h:40-197).  ``run_ahead`` 0 is the fully
    serial loop (the same code path).

    ``radio(slot, td)`` carries one slot's DL samples and returns the
    received block, or None on underflow (counted; the slot's UL is
    skipped).  ``payloads(slot)`` gives the slot's (U, TBS) bits.  A slot
    whose UL processing raises is counted as an error and dropped
    (``fail_open``); a request for a slot already passed is counted LATE and
    dropped; a slot over its real-time budget (a generous host-IO run-ahead
    of 5000 slots: the loop is a functional loopback, not the benchmark) is
    counted LATE.  Every event goes to ``notifier``.
    """
    t = proc.cell.timing
    notifier = notifier or RadioEventNotifier()
    slot_clock = SlotClock(notifier)
    deadline = SlotDeadline(t.cp.total / t.srate, run_ahead=5000,
                            notifier=notifier)
    run_ahead = max(0, run_ahead)
    depth = 2 if run_ahead else 0
    dl_q: deque = deque()   # (slot, deadline token, payloads, DL samples)
    ul_q: deque = deque()   # (slot, token, payloads, submit time, UL result)
    lat_ms: list[float] = []
    counts = {"ok": 0, "exact": 0}
    next_dl = 0
    t0 = time.time()

    def dispatch_dl():
        nonlocal next_dl
        slot = next_dl
        next_dl += 1
        if slot_clock.advance(slot) is None:
            return  # stale request: counted LATE, dropped (puxch rule)
        pay = payloads(slot)
        dl_q.append((slot, deadline.start(), pay, proc.process_dl_slot(pay)))

    def sync_ul(min_inflight):
        while len(ul_q) > min_inflight:
            slot, tok, pay, t_sub, res = ul_q.popleft()
            if res is None:
                continue  # UL processing error: counted, the cell stays up
            hat, tb_ok = res
            exact = tb_ok & torch.all(hat == pay.to(hat.device), dim=-1)
            okv, exv = torch.stack([tb_ok, exact]).cpu().numpy()
            counts["ok"] += int(okv.sum())
            counts["exact"] += int(exv.sum())
            if not okv.all():
                log(f"slot {slot}: CRC failures {np.nonzero(~okv)[0]}")
            deadline.finish(slot, tok)
            lat_ms.append((time.time() - t_sub) * 1e3)

    while next_dl < n_slots or dl_q:
        while next_dl < n_slots and len(dl_q) <= run_ahead:
            dispatch_dl()
        if not dl_q:
            break
        slot, tok, pay, td = dl_q.popleft()
        got = radio(slot, td)
        if got is None:
            # Radio underflow: count the event and skip the slot's UL (the
            # reference notifies and keeps the cell alive).
            notifier.on_underflow(slot)
            continue
        res = fail_open(notifier, slot, lambda: proc.process_ul_slot(got))
        ul_q.append((slot, tok, pay, time.time(), res))
        sync_ul(depth)
    sync_ul(0)
    return LoopResult(nof_tbs=n_slots * proc.cell.nof_ue,
                      ok_count=counts["ok"], exact_count=counts["exact"],
                      seconds=time.time() - t0, latency_ms=lat_ms)


def awgn_np(x: np.ndarray, snr_db: float, rng: np.random.Generator) -> np.ndarray:
    """``x`` plus complex AWGN at ``snr_db`` below its mean power, drawn
    from ``rng`` (real parts, then imaginary parts: the app's draw order)."""
    nv = float((np.abs(x) ** 2).mean()) * 10 ** (-snr_db / 10)
    noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    return x + (noise * np.sqrt(nv / 2)).astype(np.complex64)


def _radio_roundtrip(tx, rx, samples: np.ndarray, snr_db: float,
                     rng: np.random.Generator, total: int):
    """Push DL samples through the ZMQ bridge with AWGN, pull them back.
    Returns the received block or None on underflow."""
    tx.push(awgn_np(samples, snr_db, rng))
    got = np.empty(0, np.complex64)
    deadline = time.time() + 5.0
    while len(got) < total and time.time() < deadline:
        chunk = rx.pull(total - len(got))
        got = np.concatenate([got, chunk]) if len(chunk) else got
        if len(got) < total:
            time.sleep(0.0005)
    return got if len(got) >= total else None


@dataclasses.dataclass
class SchedResult:
    """What ``run_scheduled`` counted: the figures the reference app prints."""

    code: int = 1                  # 0 when the run met the app's criteria
    seconds: float = 0.0           # wall time of the slot loop
    tb_count: int = 0              # DL TBs received by the UEs
    ok_count: int = 0
    dl_retx: int = 0
    dl_retx_ok: int = 0            # recovered by soft combining
    dl_dropped: int = 0
    dl_in_flight: int = 0
    ul_tb: int = 0
    ul_ok: int = 0
    ul_retx: int = 0
    ul_retx_ok: int = 0
    ul_dropped: int = 0
    ul_in_flight: int = 0
    sr_sent: int = 0
    sr_detected: int = 0
    bsr_rx: int = 0
    bytes_served: dict[int, int] = dataclasses.field(default_factory=dict)
    ul_served: dict[int, int] = dataclasses.field(default_factory=dict)
    build_ms: list[float] = dataclasses.field(default_factory=list)  # per layout
    attached: list[int] = dataclasses.field(default_factory=list)    # RNTIs
    ue_states: set[str] = dataclasses.field(default_factory=set)
    sib1_rx: int = 0
    paging_rx: int = 0
    paged_ids: list[int] = dataclasses.field(default_factory=list)
    host_syncs: int = 0            # device -> host reads of results

    @property
    def layouts(self) -> int:
        """Grant layouts built (one HeteroCellProcessor each)."""
        return len(self.build_ms)


class _AttachingUe:
    """UE-side RA state machine for the --rach overlay (the srsue role:
    idle -> preamble -> RAR monitored -> Msg3 -> contention resolved)."""

    def __init__(self, preamble: int, ue_id48: int):
        self.state = "idle"
        self.preamble = preamble
        self.ue_id48 = ue_id48
        self.tc_rnti = None
        self.msg3_slot = None
        self.msg3_grant = None          # (start_prb, nof_prb, mcs)


def _rach_overlay_setup(cfg, cell, rng, n_ues: int):
    """PRACH occasion geometry + UE FSMs + the gNB RA procedure."""
    from .mac import rach as rach_mod
    from .ops import prach as prach_mod

    t = cell.timing
    pcfg = prach_mod.PrachConfig(root_sequence_index=1,
                                 zero_correlation_zone=13)
    info = prach_mod.prach_ofdm_info(int(t.srate))
    rcfg = rach_mod.RachConfig(bwp_prbs=cfg.nof_prb)
    proc = rach_mod.RachProcedure(rcfg)
    ues = [_AttachingUe(preamble=7 + 11 * u,
                        ue_id48=int(rng.integers(0, 1 << 48)))
           for u in range(n_ues)]
    return pcfg, info, rcfg, proc, ues


def run_scheduled(args, cfg, cell, radio: Callable, agent,
                  notifier: RadioEventNotifier, rng: np.random.Generator,
                  device: str | torch.device = "cuda",
                  log: Callable[[str], None] = print) -> SchedResult:
    """The scheduled cell: MAC grants (policy + EdgeRIC overrides) drive a
    HeteroCellProcessor per grant layout slot by slot — the cell_scheduler
    run_slot -> FAPI -> PDSCH sequence of the reference, with one processor
    (plans and constant tensors) cached per RBG-quantized grant layout.

    ``args``: the app's parsed options (``slots``, ``snr``, ``sched``,
    ``rach``, ``bcch``, ``ul_traffic``, ``ul_fade``, ``ul_fade_snr``,
    ``dl_fade``, ``dl_fade_snr``).  ``radio(slot, samples, snr_db)`` carries
    one slot's (total,) samples on ``device`` and returns the received
    block there, or None on underflow.  ``agent``: an EdgeRIC agent
    (``get_weights``, ``get_mcs``, ``send_metrics``, ``tti``,
    ``weights_age``) or None.  ``rng`` draws the traffic in the reference
    app's order: the attaching UEs' identities, then per slot the UL
    arrivals and SDU bytes, the DL arrivals and payload bits; a radio that
    adds noise from the same generator keeps the whole run's draws in that
    order.

    With ``args.rach`` N the cell starts EMPTY: N UEs attach through the
    full random-access procedure over the radio loop (PRACH occasion ->
    detect -> RAR PDSCH at RA-RNTI -> Msg3 PUSCH -> contention resolution ->
    the UE enters the scheduler), the reference's prach_sch/ra_sch slot
    sequence (cell_scheduler.cpp:117-138) + mac_ctrl UE creation.

    Every HARQ-ACK and CRC is read on the host before the next slot (one
    read per UE and slot, counted in ``host_syncs`` with every other read
    of a device result); soft buffers stay on ``device`` per (RNTI, pid)
    and are freed where the TB is delivered or dropped.
    """
    from .mac import scheduler as mac
    from .models.hetero_cell import HeteroCellProcessor
    from .models.pdsch import PdschConfig
    from .runtime.edgeric import cqi_from_sinr_db

    dev = resolve_device(device)
    t = cell.timing
    res = SchedResult()
    procs: dict[tuple, HeteroCellProcessor] = {}

    def hetero(key, cfgs):
        if key not in procs:
            t0 = time.perf_counter()
            procs[key] = HeteroCellProcessor(t, cfgs, device=dev)
            res.build_ms.append((time.perf_counter() - t0) * 1e3)
        return procs[key]

    def host(x: torch.Tensor) -> np.ndarray:
        res.host_syncs += 1
        return x.cpu().numpy()

    def on_dev(x) -> torch.Tensor:
        return torch.as_tensor(x, device=dev)

    def zeros_soft(proc, i):
        return torch.zeros(proc.soft_buffer_shape(i), dtype=torch.float32,
                           device=dev)

    def silence():
        return torch.zeros(t.cp.total, dtype=torch.complex64, device=dev)

    rach_n = args.rach
    rntis = [] if rach_n else [0x4601 + u for u in range(cell.nof_ue)]
    scfg = mac.SchedulerConfig(
        nof_prb=cfg.nof_prb,
        policy="time_rr" if args.sched == "rr" else "time_pf",
        rbg_size=mac.rbg_size_for_bwp(cfg.nof_prb))
    sched = mac.CellScheduler(scfg, rntis)
    for r in rntis:
        sched.handle_csi(r, cqi_from_sinr_db(args.snr), args.snr)
    # Uneven traffic so policies visibly differ: UE u gets ~(u+1) shares.
    mean_arrival = {r: 2000 * (u + 1) for u, r in enumerate(rntis)}
    bytes_served = res.bytes_served
    bytes_served.update(dict.fromkeys(rntis, 0))
    # DL HARQ stores: gNB keeps the in-flight TB (to re-encode at the next
    # rv), the UE keeps its soft buffer (dl_harq_process soft combining).
    # PUCCH-reported ACK/NACK feeds sched.handle_dl_ack.
    dl_harq_tb: dict = {}
    dl_ue_soft: dict = {}
    dl_faded = False
    sched.enable_harq()              # this loop plumbs DL ACK + UL CRC

    if rach_n:
        from .mac import rach as rach_mod
        from .ops import prach as prach_mod
        from .ran import tbs as tbs_mod
        pcfg, pinfo, rcfg, ra_proc, att_ues = _rach_overlay_setup(
            cfg, cell, rng, rach_n)
        prach_cache: dict[int, torch.Tensor] = {}
        msg4_queue: list = []

        def msg3_cfg(start, length, mcs_idx, rnti):
            m = tbs_mod.mcs_config(mcs_idx, "qam64")
            return PdschConfig(rnti=rnti, nof_prb=length, start_prb=start,
                               modulation=m.modulation,
                               target_rate=m.target_rate)

    bcch_on = args.bcch
    if bcch_on:
        from .mac import bcch as bcch_mod
        si_sched = bcch_mod.SiScheduler(bcch_mod.SiConfig())
        # Short DRX cycle so paging occasions land within the run.
        pg_sched = bcch_mod.PagingScheduler(
            bcch_mod.PagingConfig(drx_cycle_frames=2))

    ul_mean = args.ul_traffic
    if ul_mean:
        from .mac import ul_procedures as ulp
        from .ops import ofdm as ofdm_mod
        from .ops import pucch as pucch_mod
        sr_cfg = ulp.SrConfig()
        ue_q: dict = {}                  # UE-side queues (bytes)
        ul_served = res.ul_served
        # HARQ stores (keyed (rnti, pid)): the UE keeps the MAC PDU it must
        # retransmit; the gNB keeps the accumulated soft buffer
        # (rx_buffer_pool reservation).  CRC results feed
        # sched.handle_crc_indication -> retx grants at the next rv.
        harq_ue_tb: dict = {}            # UE side: in-flight payload
        harq_gnb_soft: dict = {}         # gNB side: (C, N_cb) soft state
        ul_faded = False

    t0 = time.time()
    for slot in range(args.slots):
        if bcch_on and slot == 3:
            # A page arrives from the core (CU-CP Paging over NG): enqueue
            # it; the scheduler serves it at the UE's TS 38.304 occasion.
            pg_sched.page_ue(7, b"page7")
            res.paged_ids.append(7)

        if ul_mean:
            # ---- UL data leg: SR -> UL grant -> PUSCH w/ BSR MAC CE ----
            # (ue_scheduling ul_sched + mac_ul counterpart; see
            # mac/ul_procedures.py)
            ue_list = list(sched.ues)
            for r in ue_list:
                ue_q[r] = ue_q.get(r, 0) + int(rng.poisson(ul_mean))
                ul_served.setdefault(r, 0)
            ul_grants = sched.run_slot_ul()
            ul_td = silence()
            ul_active = False
            proc_u = None
            if ul_grants:
                ukey = ("ul",) + tuple(
                    (g.rnti, g.start_prb, g.nof_prb, g.qm, g.target_rate)
                    for g in ul_grants)
                proc_u = hetero(ukey, sched.to_pdsch_configs(ul_grants))
                pls = []
                for g, cap in zip(ul_grants, proc_u.tbs):
                    if g.is_retx:
                        # The UE retransmits the stored MAC PDU at the
                        # granted rv (same TBS by construction).
                        pls.append(harq_ue_tb[(g.rnti, g.pid)])
                        res.ul_retx += 1
                        continue
                    take = min(ue_q[g.rnti], ulp.sdu_capacity(cap))
                    sdu = rng.integers(0, 256, take,
                                       dtype=np.uint8).tobytes()
                    ue_q[g.rnti] -= take
                    pl = on_dev(ulp.build_ul_mac_pdu(ue_q[g.rnti], sdu,
                                                     cap)[None])
                    harq_ue_tb[(g.rnti, g.pid)] = pl
                    pls.append(pl)
                ul_td += proc_u.process_ul_tx_rv_slot(
                    pls, tuple(g.rv for g in ul_grants))
                ul_active = True
            sr_ues = []
            if sr_cfg.is_occasion(slot):
                granted = {g.rnti for g in ul_grants}
                for i, r in enumerate(ue_list):
                    if ue_q[r] > 0 and r not in granted:
                        f0c = pucch_mod.Pucch01Config(
                            n_id=cell.n_id, slot=slot % 10,
                            start_symbol=sr_cfg.start_symbol,
                            nof_symbols=sr_cfg.nof_symbols, initial_cs=0,
                            prb=sr_cfg.prb)
                        grid = torch.zeros((t.nsymb, t.nof_subc),
                                           dtype=torch.complex64, device=dev)
                        grid[sr_cfg.start_symbol,
                             12 * sr_cfg.prb:12 * (sr_cfg.prb + 1)] += \
                            pucch_mod.format0_generate(
                                f0c, sr_cfg.m0_of_ue(i), device=dev)[0]
                        ul_td += ofdm_mod.modulate_slot(grid, t)
                        sr_ues.append(i)
                        res.sr_sent += 1
                ul_active = ul_active or bool(sr_ues)
            # --ul-fade: one deep-fade slot (low SNR) forcing CRC NACKs so
            # the HARQ retx loop is exercised over the radio.  The fade hits
            # the first slot at/after the given index that actually carries
            # a new-tx PUSCH.
            fade_now = (args.ul_fade >= 0 and not ul_faded
                        and slot >= args.ul_fade
                        and any(not g.is_retx for g in ul_grants))
            if fade_now:
                ul_faded = True
            ul_snr = args.ul_fade_snr if fade_now else args.snr
            got_u = radio(slot, ul_td, ul_snr) if ul_active else None
            if got_u is not None:
                if sr_cfg.is_occasion(slot) and sr_ues:
                    rx_grid = ofdm_mod.demodulate_slot(got_u, t)
                    sr_res = rx_grid[sr_cfg.start_symbol,
                                     12 * sr_cfg.prb:12 * (sr_cfg.prb + 1)]
                    f0c = pucch_mod.Pucch01Config(
                        n_id=cell.n_id, slot=slot % 10,
                        start_symbol=sr_cfg.start_symbol,
                        nof_symbols=sr_cfg.nof_symbols, initial_cs=0,
                        prb=sr_cfg.prb)
                    cands = tuple(sr_cfg.m0_of_ue(i)
                                  for i in range(len(ue_list)))
                    metrics, _ = pucch_mod.format0_detect(sr_res[None], f0c,
                                                          cands)
                    for i, m in enumerate(host(metrics)):
                        if float(m) > 0.4:
                            r = ue_list[i]
                            res.sr_detected += 1
                            sched.update_buffer(r, ul_bytes=max(
                                sched.ues[r].ul_buffer,
                                sr_cfg.sr_grant_bytes))
                if proc_u is not None:
                    softs = [harq_gnb_soft.get((g.rnti, g.pid)) if g.is_retx
                             else None for g in ul_grants]
                    softs = [s if s is not None else zeros_soft(proc_u, i)
                             for i, s in enumerate(softs)]
                    outs = proc_u.process_ul_harq_slot(
                        got_u, softs, tuple(g.rv for g in ul_grants))
                    for g, (hat, okb, _, _, soft_new) in zip(ul_grants,
                                                             outs):
                        res.ul_tb += 1
                        good = bool(host(okb).all())
                        sched.handle_crc_indication(g.rnti, g.pid, good)
                        if not good:
                            # rx_buffer carry for the soft-combined retx.
                            harq_gnb_soft[(g.rnti, g.pid)] = soft_new
                            p = sched.ues[g.rnti].ul_harq.procs[g.pid]
                            if not p.busy:       # dropped at max retx
                                res.ul_dropped += 1
                                harq_ue_tb.pop((g.rnti, g.pid), None)
                                harq_gnb_soft.pop((g.rnti, g.pid), None)
                            continue
                        res.ul_ok += 1
                        if g.is_retx:
                            res.ul_retx_ok += 1
                            log(f"slot {slot}: HARQ retx rv={g.rv} decoded "
                                f"(soft-combined) for rnti={g.rnti:#x}")
                        harq_ue_tb.pop((g.rnti, g.pid), None)
                        harq_gnb_soft.pop((g.rnti, g.pid), None)
                        reported, sdu = ulp.parse_ul_mac_pdu(
                            host(hat).reshape(-1))
                        res.bsr_rx += 1
                        ul_served[g.rnti] += len(sdu)
                        # The BSR overrides the scheduler's decayed view
                        # with the UE's true remaining queue.
                        sched.update_buffer(g.rnti, ul_bytes=reported)

        ctrl_dl = None                # (kind, payload) control-plane PDSCH
        if rach_n:
            # ---- UL leg: PRACH occasion + Msg3 PUSCH over the radio ----
            occasion = (slot % 10 == 5)
            ul_td = silence()
            ul_active = False
            for ue in att_ues:
                if ue.state == "idle" and occasion:
                    if ue.preamble not in prach_cache:
                        prach_cache[ue.preamble] = prach_mod.ofdm_modulate_prach(
                            prach_mod.generate(pcfg, ue.preamble, device=dev),
                            pinfo)
                    w = prach_cache[ue.preamble]
                    ul_td[:len(w)] += w
                    ue.state = "wait_rar"
                    ul_active = True
                elif ue.state == "wait_msg3" and slot == ue.msg3_slot:
                    m3p = hetero(("msg3", ue.tc_rnti, ue.msg3_grant),
                                 [msg3_cfg(*ue.msg3_grant, ue.tc_rnti)])
                    bits = rach_mod.encode_msg3_ccch(ue.ue_id48)
                    pl = np.zeros((1, m3p.tbs[0]), np.int8)
                    pl[0, :len(bits)] = bits
                    ul_td = ul_td + m3p.process_ul_tx_slot([on_dev(pl)])
                    ue.state = "wait_conres"
                    ul_active = True
            got_ul = radio(slot, ul_td, args.snr) if ul_active else None
            # ---- gNB: PRACH detection (uplink_processor -> MAC rach
            # indication) ----
            if occasion and got_ul is not None:
                win = got_ul[:pinfo.cp_samples
                             + pinfo.n_reps * pinfo.dft_size]
                det = prach_mod.detect(
                    prach_mod.ofdm_demodulate_prach(win, pinfo), pcfg)
                found = np.nonzero(host(det.detected))[0]
                delays = host(det.delays) if len(found) else None
                for p in found:
                    delay_s = float(delays[p]) / (pcfg.l_ra * 1250.0)
                    ra_proc.handle_prach_detection(slot, int(p), delay_s)
                    log(f"slot {slot}: PRACH preamble {int(p)} detected")
            # ---- gNB: ra_scheduler::run_slot (RAR + Msg3 grants) ----
            rar, msg3_due = ra_proc.run_slot(slot)
            for m in msg3_due:
                if got_ul is None:
                    ra_proc.handle_msg3_crc(m.tc_rnti, False, None)
                    continue
                grant = (m.start_prb, m.nof_prb, m.mcs)
                m3p = hetero(("msg3", m.tc_rnti, grant),
                             [msg3_cfg(*grant, m.tc_rnti)])
                hat, okb, _, _ = m3p.process_ul_slot(got_ul)[0]
                conn = ra_proc.handle_msg3_crc(
                    m.tc_rnti, bool(host(okb).all()), host(hat))
                if conn is not None:
                    # mac_ctrl UE creation: the UE joins the scheduler.
                    sched.ues[conn.c_rnti] = mac.SchedUe(rnti=conn.c_rnti)
                    sched.handle_csi(conn.c_rnti, cqi_from_sinr_db(args.snr),
                                     args.snr)
                    bytes_served[conn.c_rnti] = 0
                    mean_arrival[conn.c_rnti] = 2000 * len(bytes_served)
                    msg4_queue.append((conn.c_rnti, conn.msg4_bits))
                    res.attached.append(conn.c_rnti)
                    log(f"slot {slot}: Msg3 ok, UE rnti={conn.c_rnti:#x} "
                        f"connected")
            if rar is not None:
                ctrl_dl = ("rar", rar)
            elif msg4_queue:
                ctrl_dl = ("msg4", msg4_queue.pop(0))

        if bcch_on and ctrl_dl is None:
            # SIB1/SI + paging occasions (cell_scheduler.cpp:123-126,:137).
            g = si_sched.run_slot(slot) or pg_sched.run_slot(slot)
            if g is not None:
                ctrl_dl = ("bcch", g)

        if ctrl_dl is not None:
            # Control-plane PDSCH (RAR at RA-RNTI / Msg4 conres at C-RNTI /
            # SIB1 / paging) takes this slot's DL; the UE side decodes it
            # and advances its FSM.
            kind, item = ctrl_dl
            if kind == "rar":
                rnti, bits = item.ra_rnti, item.payload_bits
            elif kind == "bcch":
                rnti, bits = item.rnti, item.payload_bits
            else:
                rnti, bits = item
            # ~30 payload bits/PRB at QPSK r0.12: size the control PDSCH to
            # the PDU (a multi-subPDU RAR grows with the occasion's load).
            n_prb = max(4, -(-len(bits) // 30) + 1)
            c_cfg = PdschConfig(rnti=rnti, nof_prb=n_prb, start_prb=0,
                                modulation="qpsk", target_rate=0.12)
            cp_ = hetero(("ctrl", rnti, n_prb), [c_cfg])
            pl = np.zeros((1, cp_.tbs[0]), np.int8)
            pl[0, :len(bits)] = bits
            got = radio(slot, cp_.process_dl_slot([on_dev(pl)]), args.snr)
            if got is None:
                notifier.on_underflow(slot)
                continue
            hat, okb, _, _ = cp_.process_dl_rx_slot(got)[0]
            if not bool(host(okb).all()):
                continue
            hat = host(hat).reshape(-1)
            if kind == "bcch":
                # UE side: verify the broadcast payload round-trips.
                nb = len(item.payload_bits)
                if not (hat[:nb] == item.payload_bits).all():
                    raise RuntimeError(f"slot {slot}: {item.kind} decoded "
                                       f"with a wrong payload")
                if item.kind == "sib1":
                    res.sib1_rx += 1
                elif item.kind == "paging":
                    recs = bcch_mod.decode_paging(hat)
                    log(f"slot {slot}: paging occasion, UE ids "
                        f"{[i for i, _ in recs]}")
                    res.paging_rx += len(recs)
                continue
            if kind == "rar":
                for sub in rach_mod.decode_rar_pdu(hat):
                    for ue in att_ues:
                        if ue.state == "wait_rar" and \
                                ue.preamble == sub.rapid:
                            ue.tc_rnti = sub.tc_rnti
                            start, length = rach_mod.riv_type1_decode(
                                sub.ul_grant.riv, rcfg.bwp_prbs)
                            ue.msg3_grant = (start, length, sub.ul_grant.mcs)
                            ue.msg3_slot = slot + rcfg.msg3_delay_slots
                            ue.state = "wait_msg3"
            else:
                ue_id = rach_mod.decode_msg4_conres(hat)
                for ue in att_ues:
                    if ue.state == "wait_conres" and ue.ue_id48 == ue_id:
                        ue.state = "connected"
                        log(f"slot {slot}: contention resolved for "
                            f"rnti={ue.tc_rnti:#x}")
            continue

        active = list(sched.ues)
        for r in active:
            sched.update_buffer(
                r, dl_bytes=sched.ues[r].dl_buffer
                + int(rng.poisson(mean_arrival[r])))
        weights = agent.get_weights(active) if agent else None
        mcs_ovr = agent.get_mcs(active) if agent else None
        grants = sched.run_slot(weights=weights, mcs_overrides=mcs_ovr)
        if agent:
            agent.send_metrics(sched.ue_reports())
        if not grants:
            continue
        proc = hetero(tuple((g.rnti, g.start_prb, g.nof_prb, g.qm,
                             g.target_rate) for g in grants),
                      sched.to_pdsch_configs(grants))
        payloads = []
        for g, n in zip(grants, proc.tbs):
            if g.is_retx:
                # gNB re-encodes the stored TB at the granted rv.
                payloads.append(dl_harq_tb[(g.rnti, g.pid)])
                res.dl_retx += 1
            else:
                pl = on_dev(rng.integers(0, 2, (1, n), dtype=np.int8))
                dl_harq_tb[(g.rnti, g.pid)] = pl
                payloads.append(pl)
        td = proc.process_dl_rv_slot(payloads, tuple(g.rv for g in grants))
        # --dl-fade: force a DL NACK -> PUCCH ACK feedback -> retx grant.
        fade_dl = (args.dl_fade >= 0 and not dl_faded
                   and slot >= args.dl_fade
                   and any(not g.is_retx for g in grants))
        if fade_dl:
            dl_faded = True
        got = radio(slot, td, args.dl_fade_snr if fade_dl else args.snr)
        if got is None:
            notifier.on_underflow(slot)
            continue
        # UE-side PDSCH receivers decode the DL (srsue role) with HARQ
        # soft combining: DL BLER, ACK/NACK feedback and the CQI feedback
        # below are exercised as actual DL.
        softs = [dl_ue_soft.get((g.rnti, g.pid)) if g.is_retx else None
                 for g in grants]
        softs = [s if s is not None else zeros_soft(proc, i)
                 for i, s in enumerate(softs)]
        outs = proc.process_dl_rx_harq_slot(got, softs,
                                            tuple(g.rv for g in grants))
        for g, (payload, ok, nv_est, _, soft_new), want in zip(grants, outs,
                                                               payloads):
            res.tb_count += 1
            good = bool(host(ok).all())
            res.ok_count += int(good)
            # The UE's HARQ-ACK reaches the scheduler (PUCCH UCI path).
            sched.handle_dl_ack(g.rnti, g.pid, good)
            if good:
                bytes_served[g.rnti] += g.tbs // 8
                if g.is_retx:
                    res.dl_retx_ok += 1
                    if not bool(host(torch.all(payload == want))):
                        raise RuntimeError(f"slot {slot}: DL retx for "
                                           f"rnti={g.rnti:#x} passed CRC "
                                           f"with a wrong payload")
                    log(f"slot {slot}: DL HARQ retx rv={g.rv} decoded "
                        f"(soft-combined) for rnti={g.rnti:#x}")
                dl_harq_tb.pop((g.rnti, g.pid), None)
                dl_ue_soft.pop((g.rnti, g.pid), None)
            else:
                dl_ue_soft[(g.rnti, g.pid)] = soft_new
                p = sched.ues[g.rnti].dl_harq.procs[g.pid]
                if not p.busy:                   # dropped at max retx
                    res.dl_dropped += 1
                    dl_harq_tb.pop((g.rnti, g.pid), None)
                    dl_ue_soft.pop((g.rnti, g.pid), None)
            nv_u = float(host(nv_est).reshape(-1)[0])
            sinr = -10.0 * np.log10(max(nv_u, 1e-12))
            sched.handle_csi(g.rnti, cqi_from_sinr_db(sinr), sinr)
    res.seconds = time.time() - t0
    res.dl_in_flight = len(dl_harq_tb)
    log(f"sched[{args.sched}] done: {args.slots} slots in {res.seconds:.2f}s, "
        f"TB success {res.ok_count}/{res.tb_count}, "
        f"{res.layouts} grant layouts built")
    log(f"bytes served: { {hex(r): b for r, b in bytes_served.items()} }")
    if agent is not None:
        log(f"edgeric: {agent.tti} TTIs; last weights age "
            f"{agent.weights_age}")
    # Delivery criterion: every DL TB either decoded first try or was
    # recovered by the HARQ retx loop (nothing dropped or stranded).
    ok = res.dl_dropped == 0 and not dl_harq_tb
    if res.dl_retx or res.dl_dropped:
        log(f"dl harq: retx {res.dl_retx_ok}/{res.dl_retx} recovered "
            f"({res.dl_dropped} dropped, {len(dl_harq_tb)} in flight)")
    if args.dl_fade >= 0:
        ok = ok and res.dl_retx_ok >= 1
    if ul_mean:
        res.ul_in_flight = len(harq_ue_tb)
        log(f"ul: {res.ul_ok}/{res.ul_tb} PUSCH ok, {res.bsr_rx} BSRs, SR "
            f"{res.sr_detected}/{res.sr_sent} detected, HARQ retx "
            f"{res.ul_retx_ok}/{res.ul_retx} recovered ({res.ul_dropped} "
            f"dropped, {len(harq_ue_tb)} in flight), served "
            f"{ {hex(r): b for r, b in ul_served.items()} }, residual "
            f"queues { {hex(r): q for r, q in ue_q.items()} }")
        # Every transmitted TB must be delivered — first try or via the
        # HARQ retx loop (nothing dropped, nothing stranded in flight).
        ok = ok and res.ul_dropped == 0 and not harq_ue_tb \
            and res.bsr_rx > 0 and res.sr_detected == res.sr_sent \
            and sum(ul_served.values()) > 0
        if args.ul_fade >= 0:
            ok = ok and res.ul_retx_ok >= 1   # the fade forced a real retx
    if bcch_on:
        log(f"bcch: {res.sib1_rx} SIB1 decoded, {res.paging_rx} paging "
            f"records received (paged {res.paged_ids})")
        ok = ok and res.sib1_rx >= 1 + (args.slots - 1) // 20 \
            and res.paging_rx == len(res.paged_ids)
    if rach_n:
        res.ue_states = {ue.state for ue in att_ues}
        log(f"rach: {len(res.attached)}/{rach_n} UEs attached "
            f"(rntis {[hex(r) for r in res.attached]}), UE states "
            f"{res.ue_states}")
        ok = ok and len(res.attached) == rach_n \
            and res.ue_states == {"connected"} and res.tb_count > 0
    res.code = 0 if ok else 1
    return res


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m srsran_edgeric_5g_tpu_torch.loopback_app")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--slots", type=int, default=20)
    ap.add_argument("--snr", type=float, default=25.0)
    ap.add_argument("--port", type=int, default=47655)
    ap.add_argument("--trace", default=None, help="write chrome trace JSON")
    ap.add_argument("--edgeric", action="store_true",
                    help="publish per-TTI metrics to an EdgeRIC muApp "
                         "(ipc:///tmp/metrics) and poll policy channels")
    ap.add_argument("--bcch", action="store_true",
                    help="schedule SIB1/SI broadcast + TS 38.304 paging "
                         "occasions in the slot loop (SI-RNTI/P-RNTI "
                         "PDSCH, UE-side decode); implies --sched")
    ap.add_argument("--ul-traffic", type=int, default=0, dest="ul_traffic",
                    help="mean UL bytes/slot/UE: drives the SR -> UL grant "
                         "-> PUSCH+BSR loop (PUCCH F0 SR occasions, TS "
                         "38.321 short-BSR MAC CE, scheduler run_slot_ul); "
                         "implies --sched")
    ap.add_argument("--ul-fade", type=int, default=-1, dest="ul_fade",
                    help="slot index hit by a deep fade (--ul-fade-snr): "
                         "forces UL CRC NACKs so the scheduler's HARQ "
                         "retx loop (CRC indication -> rv-sequence retx "
                         "grant -> soft-combined decode) runs over the "
                         "radio; -1 = off")
    ap.add_argument("--ul-fade-snr", type=float, default=3.0, dest="ul_fade_snr")
    ap.add_argument("--dl-fade", type=int, default=-1, dest="dl_fade",
                    help="like --ul-fade for the DL: forces a UE-side "
                         "PDSCH NACK so the DL HARQ loop (ACK feedback -> "
                         "retx grant -> UE soft-combined decode) runs")
    ap.add_argument("--dl-fade-snr", type=float, default=3.0, dest="dl_fade_snr")
    ap.add_argument("--rach", type=int, default=0,
                    help="start the cell EMPTY and attach N UEs via the "
                         "full random-access procedure (PRACH occasion -> "
                         "RAR -> Msg3 -> contention resolution) before "
                         "they carry scheduled traffic; implies --sched")
    ap.add_argument("--sched", choices=("off", "rr", "pf"), default="off",
                    help="run the MAC scheduler per slot: grants (RBG-"
                         "quantized, EdgeRIC-weight steerable) drive a "
                         "HeteroCellProcessor per grant layout instead of "
                         "the fixed equal split")
    ap.add_argument("--run-ahead", type=int, default=2, dest="run_ahead",
                    help="slots of DL run-ahead (the reference's "
                         "nof_slot_tti_in_advance): DL for slot s+K is "
                         "submitted before slot s finishes UL, and UL "
                         "results are read two slots late.  0 = fully "
                         "serial slot loop")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the PHY (default cuda; cpu runs "
                         "the plain versions)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    from . import config as cfg_mod
    from .models.cell_processor import CellProcessor
    from .runtime import IqRxClient, IqTxServer
    from .utils.metrics import StdoutSink
    from .utils.tracing import l1_tracer

    dev = resolve_device(args.device)
    cfg = cfg_mod.load(args.config) if args.config else cfg_mod.PhyConfig()
    cell = cfg.cell_config()
    agent = None
    if args.edgeric:
        from .runtime.edgeric import EdgericAgent
        agent = EdgericAgent()
    if args.trace:
        l1_tracer.enable()

    t = cell.timing
    addr = f"tcp://127.0.0.1:{args.port}"
    tx = IqTxServer(addr, chunk=t.cp.total)
    rx = IqRxClient(addr.replace("*", "localhost"), chunk=t.cp.total)

    # Failure detection: radio event counters (run_slot_loop adds the
    # skipped-slot tracking and the real-time budget check).
    notifier = RadioEventNotifier(log=lambda s: print(f"[radio] {s}", flush=True))

    rng = np.random.default_rng(0)
    tbs = cell.derived_tbs()
    print(f"cell: {cfg.bandwidth_mhz} MHz / {cfg.nof_prb} PRB, "
          f"{cell.nof_ue} UEs x {cell.prb_per_ue} PRB, TBS {tbs}, "
          f"srate {t.srate/1e6:.2f} Msps, device {dev}", flush=True)

    def log(s):
        print(s, flush=True)

    def radio(slot, td, snr_db=args.snr):
        got = _radio_roundtrip(tx, rx, td.cpu().numpy(), snr_db, rng,
                               t.cp.total)
        return None if got is None else torch.as_tensor(got, device=dev)

    if (args.rach or args.bcch or args.ul_traffic) and args.sched == "off":
        args.sched = "pf"
    try:
        if args.sched != "off":
            res = run_scheduled(args, cfg, cell, radio, agent, notifier, rng,
                                device=dev, log=log)
            return res.code

        proc = CellProcessor(cell, pci=cfg.pci, device=dev)
        proc.metrics.add_sink(StdoutSink(every=max(1, args.slots // 10)))
        er_sink = None
        if agent is not None:
            from .runtime.edgeric import EdgericMetricsSink
            er_sink = EdgericMetricsSink(agent)
            proc.metrics.add_sink(er_sink)

        def payloads(slot):
            return torch.as_tensor(rng.integers(0, 2, (cell.nof_ue, tbs),
                                                dtype=np.int8), device=dev)

        res = run_slot_loop(proc, radio, args.slots, payloads, run_ahead=args.run_ahead,
                            notifier=notifier, log=log)
    finally:
        rx.stop()
        tx.stop()
        if agent is not None:
            agent.close()

    n = res.nof_tbs
    tp = proc.metrics.throughput_mbps()
    dt = res.seconds
    print(f"done: {args.slots} slots in {dt:.2f}s "
          f"({args.slots / dt:.1f} slot/s incl. host IO), "
          f"TB success {res.ok_count}/{n}", flush=True)
    if res.latency_ms:
        print(f"slot latency (radio-roundtrip submit -> UL decoded, "
              f"run-ahead {max(0, args.run_ahead)}): p50 "
              f"{float(np.percentile(res.latency_ms, 50)):.2f} ms / p99 "
              f"{float(np.percentile(res.latency_ms, 99)):.2f} ms", flush=True)
    print(f"radio events: {notifier.events.as_dict()}", flush=True)
    print("throughput (Mbit/s @1k slots/s):",
          {hex(k): round(v, 2) for k, v in tp.items()}, flush=True)
    if er_sink is not None:
        print(f"edgeric: {agent.tti} TTIs published; last policy: "
              f"weights={er_sink.weights} mcs={er_sink.mcs} "
              f"(None = fail-open)", flush=True)
    if args.trace:
        l1_tracer.write(args.trace)
        print(f"trace written to {args.trace}", flush=True)
    return 0 if res.ok_count == n else 1


if __name__ == "__main__":
    sys.exit(main())
