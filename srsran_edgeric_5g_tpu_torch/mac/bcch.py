"""Broadcast scheduling: SIB1 / SI messages and paging.

Port of ``srsran_edgeric_5g_tpu/mac/bcch.py`` (a copy).

Counterpart of the reference's common_scheduling/{sib_scheduler.cpp,
si_message_scheduler.cpp, paging_scheduler.cpp} — the remaining common
channels of the per-slot sequence (cell_scheduler.cpp:123-126, :137):

* SIB1 is (re)transmitted every max(SSB period, sib1_retx_period) on the
  SI-RNTI with a fixed low-MCS QPSK PDSCH grant (sib_scheduler.cpp:52-53,
  :84-106).
* Additional SI messages follow their own periodicity within an SI window
  (si_message_scheduler.cpp).
* Paging occasions follow TS 38.304 §7.1: UE_ID = 5G-S-TMSI mod 1024; the
  paging frame PF satisfies (SFN + PF_offset) mod T = (T div N)(UE_ID mod
  N) (paging_scheduler.cpp:168-174), with i_s = floor(UE_ID / N) mod Ns
  selecting the occasion within the frame; pending paging records are
  packed into one P-RNTI PDSCH per occasion.

Host-side control logic like mac.scheduler; the grants map onto
models.pdsch.PdschConfig for the PHY.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SI_RNTI = 0xFFFF      # TS 38.321 Table 7.1-1
P_RNTI = 0xFFFE


@dataclasses.dataclass(frozen=True)
class BcchGrant:
    """A broadcast PDSCH for this slot (SIB1 / SI-message / paging)."""

    rnti: int
    kind: str                   # 'sib1' | 'si' | 'paging'
    payload_bits: np.ndarray
    start_prb: int
    nof_prb: int
    modulation: str = "qpsk"
    target_rate: float = 0.12


@dataclasses.dataclass(frozen=True)
class SiConfig:
    """SI scheduling parameters (expert cfg + ServingCellConfigCommon)."""

    sib1_payload: bytes = b"\x40\x48\x0a\x03"   # opaque RRC bytes
    sib1_period_ms: int = 20    # max(ssb 10/20 ms, sib1_retx 20 ms) default
    sib1_start_prb: int = 0
    sib1_nof_prb: int = 6
    # Additional SI messages: list of (payload bytes, si-Periodicity in
    # RADIO FRAMES — TS 38.331 rf8..rf512; message order = position in
    # schedulingInfoList, which fixes its SI window).
    si_messages: tuple = ()
    # si-WindowLength in slots (TS 38.331 s5..s1280, shared by all SI
    # messages).
    si_window_slots: int = 5
    mu: int = 0                 # numerology: 10 * 2^mu slots per frame

    @property
    def slots_per_frame(self) -> int:
        return 10 * (1 << self.mu)

    @property
    def slots_per_ms(self) -> int:
        return 1 << self.mu


class SiScheduler:
    """SIB1 + SI-message broadcast (sib_scheduler.cpp:84-106 +
    si_message_scheduler.cpp), with the TS 38.331 §5.2.2.3.2 SI-window
    association: message n (1-based) owns the window starting at
    x = (n-1)*w slots into the frame SFN with SFN mod T = floor(x/N)
    (w = si-WindowLength, T = si-Periodicity in frames, N = slots/frame);
    the message transmits at the first window slot not taken by SIB1."""

    def __init__(self, cfg: SiConfig):
        self.cfg = cfg

    def _sib1_due(self, slot: int) -> bool:
        # Time-true period at any numerology: 20 ms = 20 * 2^mu slots.
        return slot % (self.cfg.sib1_period_ms * self.cfg.slots_per_ms) == 0

    def run_slot(self, slot: int) -> BcchGrant | None:
        c = self.cfg
        if self._sib1_due(slot):
            return BcchGrant(rnti=SI_RNTI, kind="sib1",
                             payload_bits=_bytes_to_bits(c.sib1_payload),
                             start_prb=c.sib1_start_prb,
                             nof_prb=c.sib1_nof_prb)
        n_sl = c.slots_per_frame
        sfn = slot // n_sl
        slot_in_frame = slot % n_sl
        w = c.si_window_slots
        for n, (payload, period_rf) in enumerate(c.si_messages, start=1):
            x = (n - 1) * w
            if sfn % period_rf != (x // n_sl) % period_rf:
                continue
            start = x % n_sl
            # First in-window slot not claimed by SIB1 (one tx per window,
            # si_message_scheduler repetition count 1).
            for a in range(start, min(start + w, n_sl)):
                if not self._sib1_due(sfn * n_sl + a):
                    break
            if slot_in_frame == a:
                return BcchGrant(rnti=SI_RNTI, kind="si",
                                 payload_bits=_bytes_to_bits(payload),
                                 start_prb=c.sib1_start_prb,
                                 nof_prb=c.sib1_nof_prb)
        return None


@dataclasses.dataclass(frozen=True)
class PagingConfig:
    """PCCH-Config (TS 38.331): DRX cycle T, PFs per cycle, Ns, offset."""

    drx_cycle_frames: int = 128          # default_paging_cycle rf128
    nof_pf_per_drx: int = 1              # pcch nof_pf 'oneT' -> N = T/1
    paging_frame_offset: int = 0
    ns: int = 1                          # paging occasions per PF
    mu: int = 0                          # numerology

    @property
    def slots_per_frame(self) -> int:
        return 10 * (1 << self.mu)


class PagingScheduler:
    """TS 38.304 §7.1 occasion computation + pending-record queue
    (paging_scheduler.cpp:140-230)."""

    def __init__(self, cfg: PagingConfig):
        self.cfg = cfg
        self.pending: dict[int, bytes] = {}     # UE_ID -> paging record

    def page_ue(self, ue_id_1024: int, record: bytes = b"\x01") -> None:
        """Enqueue a page (ue_id = 5G-S-TMSI mod 1024)."""
        self.pending[ue_id_1024 % 1024] = record

    def _occasion(self, ue_id: int) -> tuple[int, int]:
        """-> (PF index within the DRX cycle, i_s occasion index)."""
        c = self.cfg
        t = c.drx_cycle_frames
        n = t // c.nof_pf_per_drx
        pf = ((t // n) * (ue_id % n) - c.paging_frame_offset) % t
        i_s = (ue_id // n) % c.ns
        return pf, i_s

    def run_slot(self, slot: int) -> BcchGrant | None:
        if not self.pending:
            return None
        c = self.cfg
        sfn = (slot // c.slots_per_frame) % 1024
        slot_in_frame = slot % c.slots_per_frame
        due = []
        for ue_id in list(self.pending):
            pf, i_s = self._occasion(ue_id)
            # i_s spreads the Ns occasions evenly over the PF (the default
            # SearchSpaceId-0 association: Ns=2 puts PO 1 at the half-frame
            # boundary — 5 * 2^mu — not at slot 1).
            if sfn % c.drx_cycle_frames == pf and \
                    slot_in_frame == i_s * (c.slots_per_frame // c.ns):
                due.append(ue_id)
        if not due:
            return None
        # One paging PDSCH carries all records of the occasion (short
        # paging PDU: count + per-UE id+record).
        records = []
        for ue_id in due:
            rec = self.pending.pop(ue_id)
            records.append((ue_id, rec))
        payload = _encode_paging(records)
        return BcchGrant(rnti=P_RNTI, kind="paging", payload_bits=payload,
                         start_prb=6, nof_prb=4)


def _bytes_to_bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8)).astype(np.int8)


def _encode_paging(records: list[tuple[int, bytes]]) -> np.ndarray:
    """count(8) + per record: ue_id(10) + len(6) + bytes."""
    bits: list[int] = []

    def put(v, w):
        for i in range(w - 1, -1, -1):
            bits.append((v >> i) & 1)

    put(len(records), 8)
    for ue_id, rec in records:
        put(ue_id, 10)
        put(len(rec), 6)
        for byte in rec:
            put(byte, 8)
    return np.asarray(bits, np.int8)


def decode_paging(bits: np.ndarray) -> list[tuple[int, bytes]]:
    """UE-side parse of the paging PDU."""
    pos = 0

    def get(w):
        nonlocal pos
        v = 0
        for i in range(w):
            v = (v << 1) | int(bits[pos + i])
        pos += w
        return v

    out = []
    for _ in range(get(8)):
        ue_id = get(10)
        n = get(6)
        out.append((ue_id, bytes(get(8) for _ in range(n))))
    return out
