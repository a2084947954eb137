"""The random bit inputs of one step of the full slot: what the harness
draws from the seed and hands to the measured package and to this
reference alike."""

from __future__ import annotations


def shapes(fc, s: int) -> dict[str, tuple[int, ...]]:
    """The name and shape of each bit input of one step of ``s`` slots, in
    the order the harness draws them: the DL payloads of the normal and the
    SSB slots, two DCIs per UE and slot, the MIBs, and the UL payloads, ACK
    and CSI bits; the UL on every slot."""
    u = fc.nof_ue
    cell_n, cell_s = ((fc.dl_cell_mimo(), fc.dl_cell_ssb_mimo()) if fc.n_layers > 1
                      else (fc.dl_cell(), fc.dl_cell_ssb()))
    n_ssb = len(fc.ssb_slots(s))
    return {"pay_n": (len(fc.norm_slots(s)), u, cell_n.derived_tbs()),
            "pay_s": (n_ssb, u, cell_s.derived_tbs()),
            "dci": (s, 2 * u, fc.dci_bits),
            "pbch": (n_ssb, 24),
            "pay_u": (s, u, fc.ul_cell().derived_tbs()),
            "ack": (s, u, 2),
            "csi": (len(fc.csi_slots(s)), u, fc.csi_bits)}
