"""The comparison that decides ``correct``: what the timed path produced in
its last step, held to the plain reference run on the same inputs, and the
window's TBs held to the payloads sent.

Numbers compared (each with its limit from the configuration's file):

* ``dl_err``: the largest gap between the DL samples of the last step and
  the reference's, over the reference's largest sample magnitude.  The DL
  samples carry PDSCH, PDCCH, SSB, CSI-RS and the OFDM modulation.
* ``soft_diff``: the share of the last step's int8 HARQ soft carry that
  differs from the reference's.
* ``tb_diff``: TBs of the last step whose CRC flag or payload differs from
  the reference's.
* ``ctrl_diff``: PUCCH F1 ACK bits, F2 CSI bits and their validity flags,
  and PRACH detections of the last step that differ from the reference's.
* ``tb_fail``: TBs of the whole window that failed CRC or carried another
  payload than the one sent (the step's device counter).
"""

from __future__ import annotations

import contextlib

import torch

from .chain import full_cell_config

NAMES = ("dl_err", "soft_diff", "tb_diff", "ctrl_diff", "tb_fail")
CTRL = ("ack_bits", "csi_bits", "csi_ok", "prach_detected")


def reference_step(config: dict, x: dict, s: int, flip: float,
                   dev: torch.device, lower: bool = False, dl: bool = True):
    """The reference's (DL samples or None, UL result dict) of one step on
    the inputs ``x`` with the noise sign ``flip``; ``lower``: the control,
    its signal stages in bfloat16."""
    from .reference import control
    from .reference.parallel import full_cell as rfc

    fc = full_cell_config(rfc.FullCellConfig, config)
    mimo = fc.n_layers > 1
    ctx = control.lower_precision() if lower else contextlib.nullcontext()
    with ctx, torch.no_grad():
        td = None
        if dl:
            gnb_dl = rfc.gnb_dl_slot_batch_mimo if mimo else rfc.gnb_dl_slot_batch
            td = gnb_dl(x["pay_n"], x["pay_s"], x["dci"], x["pbch"], fc, s,
                        device=dev)
        gnb_ul = rfc.gnb_ul_slot_batch_mimo if mimo else rfc.gnb_ul_slot_batch
        res = gnb_ul(x["ul"] + x["noise"] * flip, fc, s, soft_flat=True,
                     device=dev)
    return td, res


def compare(td, res, ref_td, ref_res, tb_fail: int) -> dict:
    """The numbers compared, as floats."""
    scale = ref_td.abs().max().clamp_min(1e-30)
    out = {"dl_err": float((td - ref_td).abs().max() / scale),
           "soft_diff": float((res["soft"] != ref_res["soft"]).double().mean()),
           "tb_diff": int(((res["tb_ok"] != ref_res["tb_ok"])
                           | (res["payload"] != ref_res["payload"]).any(-1)).sum()),
           "ctrl_diff": int(sum((res[k] != ref_res[k]).sum() for k in CTRL)),
           "tb_fail": int(tb_fail)}
    return out


def judge(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit."""
    return all(numbers[k] <= limits[k] for k in NAMES)


def report(numbers: dict, limits: dict) -> dict:
    """The result line's ``check`` entry: each number with its limit."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in NAMES}


def lines(numbers: dict, limits: dict) -> list[str]:
    return [f"check {k} = {numbers[k]!r} limit {limits[k]!r}" for k in NAMES]
