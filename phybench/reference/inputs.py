"""The random bit inputs of one step of the full slot: what the harness
draws from the seed and hands to the measured package and to this
reference alike.

They follow the configuration's slot pattern (``FullCellConfig.tdd_*``):
PDSCH payloads on the full DL slots (``pay_n`` without SSB, ``pay_s`` on
the SSB slots), DCIs on the DL and special slots, UL payloads and ACK bits
on the UL slots, CSI bits on the PUCCH F2 occasions.  In paired spectrum
(``tdd_period`` 0) every slot is a DL and a UL slot."""

from __future__ import annotations


def shapes(fc, s: int) -> dict[str, tuple[int, ...]]:
    """The name and shape of each bit input of one step of ``s`` air slots,
    in the order the harness draws them: the DL payloads of the normal and
    the SSB slots, two DCIs per UE and PDCCH slot, the MIBs, and the UL
    payloads, ACK and CSI bits."""
    u = fc.nof_ue
    cell_n, cell_s = ((fc.dl_cell_mimo(), fc.dl_cell_ssb_mimo()) if fc.n_layers > 1
                      else (fc.dl_cell(), fc.dl_cell_ssb()))
    n_ssb = len(fc.ssb_slots(s))
    n_ul = len(fc.ul_slots(s))
    return {"pay_n": (len(fc.norm_slots(s)), u, cell_n.derived_tbs()),
            "pay_s": (n_ssb, u, cell_s.derived_tbs()),
            "dci": (len(fc.pdcch_slots(s)), 2 * u, fc.dci_bits),
            "pbch": (n_ssb, 24),
            "pay_u": (n_ul, u, fc.ul_cell().derived_tbs()),
            "ack": (n_ul, u, 2),
            "csi": (len(fc.csi_slots(s)), u, fc.csi_bits)}
