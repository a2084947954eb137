"""Random-access (RACH) procedure: PRACH detection -> RAR -> Msg3 -> UE.

Port of ``srsran_edgeric_5g_tpu/mac/rach.py`` (a copy).

Counterpart of the reference's ra_scheduler
(srsRAN-5G-ER/lib/scheduler/common_scheduling/ra_scheduler.cpp:201-271
``handle_rach_indication`` -> pending RAR with TC-RNTI + RAR window;
:312-330 Msg3 HARQ handling; precompute_msg3_pdus :146-199) together with
the prach_scheduler occasion bookkeeping and the mac_ctrl UE-creation step
that a successful Msg3 triggers.  Pure host-side control logic (the
reference runs it on the scheduler thread at 1 kHz) — the PHY work (PRACH
correlation, RAR PDSCH, Msg3 PUSCH) stays on the device.

Flow per TS 38.321 §5.1 (as the loopback app's ``--rach`` mode runs it):

1. ``handle_prach_detection(slot, preamble, delay)``: allocate a TC-RNTI,
   open a RAR window (ra_scheduler.cpp:240-247), queue the RAR.
2. ``run_slot(slot)``: inside the window emit a RAR PDSCH grant addressed
   to RA-RNTI carrying the TS 38.321 §6.1.5/§6.2.3 MAC subPDU (RAPID
   subheader + 7-octet RAR: TA command, 27-bit Msg3 UL grant, TC-RNTI),
   and register the Msg3 PUSCH expected ``msg3_delay`` slots later
   (get_msg3_delay, ra_scheduler.cpp:38-60).  Also returns the Msg3
   grants due in this slot so the caller can run the PUSCH receive.
3. ``handle_msg3_crc(rnti, ok, payload)``: CRC OK resolves contention —
   the TC-RNTI becomes the C-RNTI and the UE record (with its CCCH
   contention-resolution identity for the Msg4 MAC CE) is returned for
   insertion into the MAC scheduler's UE list; CRC failure retransmits up
   to ``max_msg3_harq_retx`` times (sched_cfg.max_nof_msg3_harq_retxs,
   ra_scheduler.cpp:166) then drops the procedure.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# TS 38.211 kappa units: TA command N_TA granularity is 16*64*Tc/2^mu
# seconds = 16*64 / (480e3*4096*2^mu) s  (§4.3.1, and TS 38.213 §4.2).
_TC_S = 1.0 / (480e3 * 4096)


def ra_rnti(s_id: int, t_id: int, f_id: int = 0,
            ul_carrier_id: int = 0) -> int:
    """TS 38.321 §5.1.3: RA-RNTI = 1 + s_id + 14 t_id + 1120 f_id + ..."""
    return 1 + s_id + 14 * t_id + 14 * 80 * f_id + 14 * 80 * 8 * ul_carrier_id


def ta_command_from_delay(delay_s: float, mu: int = 0) -> int:
    """12-bit absolute TA command in RAR (TS 38.213 §4.2): T_A index such
    that N_TA = T_A * 16*64/2^mu Tc covers the measured round-trip delay."""
    unit = 16.0 * 64.0 * _TC_S / (1 << mu)
    return int(np.clip(round(delay_s / unit), 0, 3846))


def riv_type1(start: int, length: int, bwp_prbs: int) -> int:
    """TS 38.214 §5.1.2.2.2 resource-indication value for (start, length)."""
    n = bwp_prbs
    if length - 1 <= n // 2:
        return n * (length - 1) + start
    return n * (n - length + 1) + (n - 1 - start)


def riv_type1_decode(riv: int, bwp_prbs: int) -> tuple[int, int]:
    """Inverse of `riv_type1` -> (start, length)."""
    n = bwp_prbs
    length = riv // n + 1
    start = riv % n
    if length > n - start:                      # the "else" branch encoding
        length = n - length + 2
        start = n - 1 - start
    return start, length


def _put_bits(buf: list[int], value: int, width: int) -> None:
    for i in range(width - 1, -1, -1):
        buf.append((value >> i) & 1)


def _get_bits(bits: np.ndarray, pos: int, width: int) -> tuple[int, int]:
    v = 0
    for i in range(width):
        v = (v << 1) | int(bits[pos + i])
    return v, pos + width


@dataclasses.dataclass(frozen=True)
class RarUlGrant:
    """The 27-bit Msg3 UL grant (TS 38.213 Table 8.2-1)."""

    freq_hopping: int           # 1 bit
    riv: int                    # 14 bits (freq-domain type-1 allocation)
    time_alloc: int             # 4 bits (row of the PUSCH TD table)
    mcs: int                    # 4 bits
    tpc: int                    # 3 bits
    csi_request: int = 0        # 1 bit


@dataclasses.dataclass(frozen=True)
class RarSubPdu:
    """One RAR MAC subPDU: RAPID subheader + 7-octet RAR payload."""

    rapid: int                  # 6-bit preamble index
    ta_cmd: int                 # 12-bit TA command
    ul_grant: RarUlGrant
    tc_rnti: int


def encode_rar_pdu(subpdus: list[RarSubPdu]) -> np.ndarray:
    """RAR MAC PDU -> int8 bit array (TS 38.321 §6.1.5: E|T|RAPID octet,
    then R|TA(12)|UL-grant(27)|TC-RNTI(16) = 7 octets per subPDU)."""
    bits: list[int] = []
    for i, sp in enumerate(subpdus):
        e = 1 if i + 1 < len(subpdus) else 0
        _put_bits(bits, e, 1)
        _put_bits(bits, 1, 1)                       # T=1: RAPID present
        _put_bits(bits, sp.rapid, 6)
        _put_bits(bits, 0, 1)                       # R
        _put_bits(bits, sp.ta_cmd, 12)
        g = sp.ul_grant
        _put_bits(bits, g.freq_hopping, 1)
        _put_bits(bits, g.riv, 14)
        _put_bits(bits, g.time_alloc, 4)
        _put_bits(bits, g.mcs, 4)
        _put_bits(bits, g.tpc, 3)
        _put_bits(bits, g.csi_request, 1)
        _put_bits(bits, sp.tc_rnti, 16)
    return np.asarray(bits, dtype=np.int8)


def decode_rar_pdu(bits: np.ndarray) -> list[RarSubPdu]:
    """Parse a RAR MAC PDU bit array (UE side of §6.1.5)."""
    out: list[RarSubPdu] = []
    pos = 0
    while True:
        e, pos = _get_bits(bits, pos, 1)
        t, pos = _get_bits(bits, pos, 1)
        rapid, pos = _get_bits(bits, pos, 6)
        if t != 1:
            break                                   # BI subheader: ignore
        _, pos = _get_bits(bits, pos, 1)
        ta, pos = _get_bits(bits, pos, 12)
        fh, pos = _get_bits(bits, pos, 1)
        riv, pos = _get_bits(bits, pos, 14)
        tda, pos = _get_bits(bits, pos, 4)
        mcs, pos = _get_bits(bits, pos, 4)
        tpc, pos = _get_bits(bits, pos, 3)
        csi, pos = _get_bits(bits, pos, 1)
        tc, pos = _get_bits(bits, pos, 16)
        out.append(RarSubPdu(rapid=rapid, ta_cmd=ta,
                             ul_grant=RarUlGrant(fh, riv, tda, mcs, tpc, csi),
                             tc_rnti=tc))
        if e == 0:
            break
    return out


def encode_msg3_ccch(ue_id48: int) -> np.ndarray:
    """Msg3 CCCH SDU bits: MAC subheader (R|R|LCID=0) + 48-bit UE identity
    (the RRCSetupRequest ue-Identity random value used for contention
    resolution, TS 38.321 §6.1.3 UE Contention Resolution Identity)."""
    bits: list[int] = []
    _put_bits(bits, 0, 2)
    _put_bits(bits, 0, 6)                           # LCID 0 = CCCH
    _put_bits(bits, ue_id48, 48)
    return np.asarray(bits, dtype=np.int8)


def decode_msg3_ccch(bits: np.ndarray) -> int | None:
    """-> 48-bit UE identity, or None if not a CCCH subPDU."""
    lcid, pos = _get_bits(bits, 2, 6)
    if lcid != 0:
        return None
    ue_id, _ = _get_bits(bits, pos, 48)
    return ue_id


def encode_msg4_conres(ue_id48: int) -> np.ndarray:
    """Msg4 MAC CE: R|R|LCID=62 (UE Contention Resolution Identity) + the
    first 48 bits of the Msg3 CCCH SDU echoed back (TS 38.321 §6.1.3.4)."""
    bits: list[int] = []
    _put_bits(bits, 0, 2)
    _put_bits(bits, 62, 6)
    _put_bits(bits, ue_id48, 48)
    return np.asarray(bits, dtype=np.int8)


def decode_msg4_conres(bits: np.ndarray) -> int | None:
    lcid, pos = _get_bits(bits, 2, 6)
    if lcid != 62:
        return None
    ue_id, _ = _get_bits(bits, pos, 48)
    return ue_id


@dataclasses.dataclass(frozen=True)
class RachConfig:
    """RA procedure parameters (scheduler_expert_config + the serving-cell
    RACH-ConfigCommon fields the ra_scheduler reads)."""

    bwp_prbs: int                       # UL BWP size for the Msg3 RIV
    ra_window_slots: int = 10           # rach-ConfigGeneric ra-ResponseWindow
    msg3_delay_slots: int = 6           # k2 + Delta (get_msg3_delay, mu=0)
    msg3_nof_prb: int = 3               # prbs for the Msg3 CCCH SDU
    msg3_mcs: int = 0                   # sched_cfg.msg3_mcs_index
    max_msg3_harq_retx: int = 4         # sched_cfg.max_nof_msg3_harq_retxs
    rar_mcs: int = 0                    # SI/RAR PDSCH MCS
    tc_rnti_base: int = 0x4601          # MIN_CRNTI allocation base
    prach_symbol: int = 0               # s_id of the occasion
    mu: int = 0


@dataclasses.dataclass
class PendingRar:
    preamble: int
    tc_rnti: int
    prach_slot: int
    window: tuple[int, int]             # [start, stop) slots
    ta_cmd: int


@dataclasses.dataclass
class PendingMsg3:
    tc_rnti: int
    expected_slot: int
    start_prb: int
    nof_prb: int
    mcs: int
    retx_left: int


@dataclasses.dataclass(frozen=True)
class RarGrant:
    """One slot's RAR PDSCH: DL allocation addressed to RA-RNTI whose
    payload is the encoded MAC RAR PDU."""

    ra_rnti: int
    payload_bits: np.ndarray
    subpdus: tuple[RarSubPdu, ...]


@dataclasses.dataclass(frozen=True)
class ConnectedUe:
    """Outcome of a successful Msg3: the UE record the MAC adds
    (mac_ctrl's ue creation on the contention-resolution path)."""

    c_rnti: int
    ue_id48: int
    msg4_bits: np.ndarray               # conres MAC CE to send as Msg4


class RachProcedure:
    """Slot-driven RA state machine for one cell."""

    def __init__(self, cfg: RachConfig, in_use_rntis: set[int] | None = None):
        self.cfg = cfg
        self.pending_rars: list[PendingRar] = []
        self.pending_msg3s: dict[int, PendingMsg3] = {}
        self._in_use = set(in_use_rntis or ())
        self._next_tc = cfg.tc_rnti_base

    # ---- step 1: PRACH indication (uplink_processor -> rach_indication)

    def _alloc_tc_rnti(self) -> int:
        for _ in range(0x10000):
            r = self._next_tc
            self._next_tc = (self._next_tc + 1) & 0xFFFF or 1
            if r not in self._in_use and r not in self.pending_msg3s:
                self._in_use.add(r)
                return r
        raise RuntimeError("TC-RNTI pool exhausted")

    def handle_prach_detection(self, slot: int, preamble: int,
                               delay_s: float = 0.0) -> int:
        """A detected preamble opens a RAR window with a fresh TC-RNTI
        (ra_scheduler.cpp:207-271).  Returns the TC-RNTI."""
        tc = self._alloc_tc_rnti()
        win = (slot + 1, slot + 1 + self.cfg.ra_window_slots)
        self.pending_rars.append(PendingRar(
            preamble=preamble, tc_rnti=tc, prach_slot=slot, window=win,
            ta_cmd=ta_command_from_delay(delay_s, self.cfg.mu)))
        return tc

    # ---- step 2: per-slot RAR + Msg3 scheduling (ra_scheduler::run_slot)

    def run_slot(self, slot: int
                 ) -> tuple[RarGrant | None, list[PendingMsg3]]:
        """Returns (RAR grant for this slot or None, Msg3 grants whose
        PUSCH is expected THIS slot)."""
        # Expire windows (the reference logs and drops, :330-339).
        for r in [r for r in self.pending_rars if slot >= r.window[1]]:
            self._in_use.discard(r.tc_rnti)
            self.pending_rars.remove(r)

        due = [r for r in self.pending_rars if r.window[0] <= slot]
        rar = None
        if due:
            subpdus = []
            next_prb = 0
            for r in due:
                grant = RarUlGrant(
                    freq_hopping=0,
                    riv=riv_type1(next_prb, self.cfg.msg3_nof_prb,
                                  self.cfg.bwp_prbs),
                    time_alloc=0, mcs=self.cfg.msg3_mcs, tpc=0)
                subpdus.append(RarSubPdu(rapid=r.preamble, ta_cmd=r.ta_cmd,
                                         ul_grant=grant, tc_rnti=r.tc_rnti))
                self.pending_msg3s[r.tc_rnti] = PendingMsg3(
                    tc_rnti=r.tc_rnti,
                    expected_slot=slot + self.cfg.msg3_delay_slots,
                    start_prb=next_prb, nof_prb=self.cfg.msg3_nof_prb,
                    mcs=self.cfg.msg3_mcs,
                    retx_left=self.cfg.max_msg3_harq_retx)
                next_prb += self.cfg.msg3_nof_prb
                self.pending_rars.remove(r)
            rar = RarGrant(
                ra_rnti=ra_rnti(self.cfg.prach_symbol,
                                due[0].prach_slot % 10),
                payload_bits=encode_rar_pdu(subpdus),
                subpdus=tuple(subpdus))

        msg3_now = [m for m in self.pending_msg3s.values()
                    if m.expected_slot == slot]
        return rar, msg3_now

    # ---- step 3: Msg3 CRC -> contention resolution (:286-310 + mac_ctrl)

    def handle_msg3_crc(self, tc_rnti: int, crc_ok: bool,
                        payload_bits: np.ndarray | None
                        ) -> ConnectedUe | None:
        m = self.pending_msg3s.get(tc_rnti)
        if m is None:
            return None
        if crc_ok and payload_bits is not None:
            ue_id = decode_msg3_ccch(np.asarray(payload_bits).reshape(-1))
            if ue_id is not None:
                del self.pending_msg3s[tc_rnti]
                return ConnectedUe(c_rnti=tc_rnti, ue_id48=ue_id,
                                   msg4_bits=encode_msg4_conres(ue_id))
        # HARQ retransmission (has_pending_retx path, :312-330): same
        # grant ``msg3_delay`` slots later, bounded retx budget.
        if m.retx_left > 0:
            m.retx_left -= 1
            m.expected_slot += self.cfg.msg3_delay_slots
        else:
            del self.pending_msg3s[tc_rnti]
            self._in_use.discard(tc_rnti)
        return None
