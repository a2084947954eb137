"""UL scheduling procedures: SR occasions, BSR, UL MAC PDU assembly.

Port of ``srsran_edgeric_5g_tpu/mac/ul_procedures.py`` (a copy).

Counterpart of the reference's uplink-driven scheduling chain
(lib/scheduler/ue_scheduling + lib/mac/mac_ul): a UE with pending data and
no grant raises a Scheduling Request on its PUCCH resource
(uci_scheduler/sr occasions); the scheduler answers with a small UL grant;
the UE's first PUSCH carries a Buffer Status Report MAC CE (TS 38.321
§5.4.5 / §6.1.3.1) telling the scheduler the real queue depth, which then
drives `CellScheduler.run_slot_ul` until the queue drains.

Host-side control logic (like mac.scheduler / mac.rach); the PHY legs are
PUCCH F0 sequences + hetero PUSCH programs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# TS 38.321 Table 6.1.3.1-1: 5-bit buffer-size index upper bounds (bytes).
# Index 0 = empty; index 31 = "greater than the last bound".
BSR_5BIT_BOUNDS = (
    0, 10, 14, 20, 28, 38, 53, 74, 102, 142, 198, 276, 384, 535, 745,
    1038, 1446, 2014, 2806, 3909, 5446, 7587, 10570, 14726, 20516, 28581,
    39818, 55474, 77284, 107669, 150000)

LCID_SHORT_BSR = 61        # TS 38.321 Table 6.2.1-2
LCID_DTCH = 4              # first DRB logical channel


def bsr_index(nof_bytes: int) -> int:
    """Queue depth -> smallest 5-bit index whose bound covers it."""
    if nof_bytes <= 0:
        return 0
    for i, bound in enumerate(BSR_5BIT_BOUNDS):
        if nof_bytes <= bound:
            return i
    return 31


def bsr_bytes(index: int) -> int:
    """5-bit index -> the upper bound the scheduler plans for."""
    if index <= 0:
        return 0
    if index >= 31:
        return 2 * BSR_5BIT_BOUNDS[-1]
    return BSR_5BIT_BOUNDS[index]


@dataclasses.dataclass(frozen=True)
class SrConfig:
    """PUCCH F0 SR resource map: UE u owns cyclic shift m0 = 3*u of the
    single-PRB F0 resource on slots where slot % period == offset
    (schedulingRequestResourceConfig counterpart)."""

    period: int = 10
    offset: int = 3
    prb: int = 0
    start_symbol: int = 13
    nof_symbols: int = 1
    sr_grant_bytes: int = 64   # scheduler's stub allocation on a bare SR

    def is_occasion(self, slot: int) -> bool:
        return slot % self.period == self.offset

    def m0_of_ue(self, ue_index: int) -> int:
        m0 = 3 * ue_index
        assert m0 < 12, "F0 fits 4 SR users per PRB at shift spacing 3"
        return m0


# ------------------------------------------------------------- UL MAC PDU

def build_ul_mac_pdu(queue_bytes: int, sdu: bytes, pdu_bits: int) -> np.ndarray:
    """Assemble [subheader(61) | short-BSR CE | subheader(4)+L16 | SDU |
    zero pad] as a bit array of exactly ``pdu_bits``.

    ``queue_bytes`` is the queue depth AFTER this PDU's SDU is removed —
    what the scheduler still needs to grant (the reference computes BSR
    after allocation the same way).
    """
    ce = bsr_index(queue_bytes) & 0x1F               # LCG 0 in bits 7..5
    hdr = bytes([LCID_SHORT_BSR, ce,
                 LCID_DTCH, (len(sdu) >> 8) & 0xFF, len(sdu) & 0xFF])
    raw = np.frombuffer(hdr + sdu, np.uint8)
    bits = np.unpackbits(raw).astype(np.int8)
    assert bits.size <= pdu_bits, (bits.size, pdu_bits)
    return np.concatenate([bits, np.zeros(pdu_bits - bits.size, np.int8)])


def parse_ul_mac_pdu(bits: np.ndarray) -> tuple[int, bytes]:
    """-> (bsr_bytes reported, SDU payload)."""
    by = np.packbits(np.asarray(bits[:bits.size - bits.size % 8],
                                np.uint8)).tobytes()
    assert by[0] == LCID_SHORT_BSR, by[0]
    reported = bsr_bytes(by[1] & 0x1F)
    assert by[2] == LCID_DTCH, by[2]
    ln = (by[3] << 8) | by[4]
    return reported, by[5:5 + ln]


def sdu_capacity(pdu_bits: int) -> int:
    """Max SDU bytes that fit a PDU of ``pdu_bits`` after the 5 header
    octets."""
    return max(0, pdu_bits // 8 - 5)
