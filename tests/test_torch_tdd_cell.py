"""The port's TDD slot pattern (``parallel/full_cell.py``), held to the
benchmark's frozen plain reference (``phybench/reference/``) on the CPU, on
inputs that ``phybench.chain.draw_inputs`` draws from a seed: srsRAN's
default ``tdd_ul_dl_cfg`` (a period of 10 slots: 6 DL slots, a special slot
with 8 DL symbols, 3 UL slots) on both 20 MHz configurations at mu = 0
(the SISO and the ``_mimo`` entry points), and the 100 MHz n78 carrier at
mu = 1, whose format-0 preamble spans two UL slots.  Also the refusals,
paired spectrum as the default, the strided views, the spans and the
``air_slots`` counter."""

import json

import numpy as np
import pytest
import torch

from phybench.chain import draw_inputs, full_cell_config
from phybench.reference.parallel import full_cell as rfc
from phybench.spec import ROOT, load_benchmark
from srsran_edgeric_5g_tpu_torch.parallel import full_cell as tfc
from srsran_edgeric_5g_tpu_torch.utils import tracing

SEED = 2 ** 31 + 4099
SNR_DB = 25.0
SRSRAN = {"tdd_period": 10, "tdd_dl_slots": 6, "tdd_dl_symbols": 8,
          "tdd_ul_slots": 3, "tdd_ul_symbols": 0}
# The occasions moved onto slots of their kind, as in the 100 MHz file:
# CSI-RS on the special slot 6, PRACH on 7, SRS on 8, PUCCH F2 on 9.
OCCASIONS = {"csi_rs_offset": 6, "prach_offset": 7, "srs_offset": 8,
             "csi_period": 10, "csi_offset": 9}
CONFIGS = {c["name"]: c["file"] for c in load_benchmark()["configs"]}
MU1 = "nr100_n78_tdd_4ue"
CPU = torch.device("cpu")
EXACT = ("soft", "payload", "tb_ok", "ack_bits", "csi_bits", "csi_ok",
         "prach_delay", "prach_detected")


def config(name: str, **fields) -> dict:
    return dict(json.loads((ROOT / CONFIGS[name]).read_text()), **fields)


def entry(mod, fc, name: str):
    return getattr(mod, name + ("_mimo" if fc.n_layers > 1 else ""))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cfg: dict, s: int) -> dict:
    """One step of the port and of the reference on the same drawn inputs;
    the air slots that the port's calls counted and the spans they
    opened."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    fc = full_cell_config(tfc.FullCellConfig, cfg)
    rf = full_cell_config(rfc.FullCellConfig, cfg)
    x = draw_inputs(cfg, s, SNR_DB, SEED, CPU)
    dl_in = (x["pay_n"], x["pay_s"], x["dci"], x["pbch"])
    rx = x["ul"] + x["noise"]
    tracing.air_slots.clear()
    tracing.l1_tracer.enable()
    try:
        out = {"fc": fc, "rf": rf, "x": x, "s": s, "cfg": cfg,
               "td": entry(tfc, fc, "gnb_dl_slot_batch")(*dl_in, fc, s, device=CPU),
               "res": entry(tfc, fc, "gnb_ul_slot_batch")(rx, fc, s, soft_flat=True,
                                                          device=CPU),
               # The reference's UE delay: PRACH_DELAY_S at the cell's rate.
               "ue": entry(tfc, fc, "ue_ul_slot_batch")(
                   x["pay_u"], x["ack"], x["csi"], fc, s, device=CPU,
                   prach_delay=round(rfc.PRACH_DELAY_S * fc.timing.srate))}
        out["events"] = list(tracing.l1_tracer._events)
    finally:
        tracing.l1_tracer.disable()
        tracing.l1_tracer.clear()
    out["counted"] = tracing.air_slots.snapshot()
    tracing.air_slots.clear()
    out["ref_td"] = entry(rfc, rf, "gnb_dl_slot_batch")(*dl_in, rf, s, device=CPU)
    out["ref_res"] = entry(rfc, rf, "gnb_ul_slot_batch")(rx, rf, s, soft_flat=True,
                                                         device=CPU)
    # draw_inputs' UL is the reference UE's (through the channel at 2 layers).
    out["ref_ue"] = (entry(rfc, rf, "ue_ul_slot_batch")(x["pay_u"], x["ack"], x["csi"],
                                                        rf, s, device=CPU)
                     if fc.n_layers > 1 else x["ul"])
    torch.set_num_threads(n)
    return out


@pytest.fixture(scope="module")
def runs():
    """Each configuration's run, made once for the module: srsRAN's pattern
    on each 20 MHz configuration at S = 10, and the 100 MHz carrier's own
    file at S = 20 (two PRACH occasions)."""
    made = {}

    def run(name: str) -> dict:
        if name not in made:
            made[name] = (_run(config(MU1), 20) if name == MU1 else
                          _run(config(name, **OCCASIONS, **SRSRAN), 10))
        return made[name]

    return run


@pytest.fixture(scope="module", params=["nr20_siso_4ue", "nr20_mimo2x2_4ue", MU1])
def cell(request, runs):
    return runs(request.param)


@pytest.fixture(scope="module")
def mu1(runs):
    return runs(MU1)


def test_the_dl_samples_are_the_references(cell):
    td, ref = cell["td"], cell["ref_td"]
    assert td.shape == ref.shape and td.shape[0] == cell["s"]
    err = float((td - ref).abs().max() / ref.abs().max())
    assert err <= cell["cfg"]["limits"]["dl_err"]
    ul = torch.as_tensor(cell["fc"].ul_slots(cell["s"]))
    assert not td[ul].any()


def test_the_ue_ul_samples_are_the_references(cell):
    ue, ref = cell["ue"], cell["ref_ue"]
    assert ue.shape == ref.shape and ue.shape[0] == cell["s"]
    assert float((ue - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_the_ul_results_are_the_references(cell):
    res, ref, x, fc = cell["res"], cell["ref_res"], cell["x"], cell["fc"]
    n_ul = len(fc.ul_slots(cell["s"]))
    assert res["payload"].shape[:2] == (n_ul, fc.nof_ue)
    for k in EXACT:
        assert res[k].dtype == ref[k].dtype and torch.equal(res[k], ref[k]), k
    assert float((res["srs_snr_db"] - ref["srs_snr_db"]).abs().max()) <= 1e-4
    assert float((res["prach_metric"] - ref["prach_metric"]).abs().max()) <= \
        1e-4 * float(ref["prach_metric"].abs().max())
    assert res["tb_ok"].all() and torch.equal(res["payload"], x["pay_u"])
    assert torch.equal(res["ack_bits"], x["ack"])
    assert torch.equal(res["csi_bits"], x["csi"]) and res["csi_ok"].all()


def test_preamble_7_is_detected_in_every_occasion(cell):
    res, fc = cell["res"], cell["fc"]
    det = res["prach_detected"]
    assert det.shape == (cell["s"] // 10, 64)
    assert [d.nonzero().flatten().tolist() for d in det] == [[7]] * len(det)
    assert (res["prach_metric"][:, 7] > fc.prach_threshold).all()


def test_the_air_slots_are_counted_by_kind(cell):
    fc, s, counted = cell["fc"], cell["s"], cell["counted"]
    n = s // 10
    span = fc.prach_span()
    up = {"ul": 3 * n, "silent": 7 * n, "prach_span": n * span}
    sfx = "_mimo" if fc.n_layers > 1 else ""
    assert counted == {f"gnb_dl_slot_batch{sfx}": {"dl": 6 * n, "special": n,
                                                   "silent": 3 * n},
                       f"gnb_ul_slot_batch{sfx}": up, f"ue_ul_slot_batch{sfx}": up}
    assert span == (2 if fc.mu else 1)


def test_the_100_mhz_preamble_spans_two_ul_slots_and_is_read_joined(mu1):
    """The format-0 preamble (12657 + 98304 samples) against 61440-sample
    slots: the UE sends it over UL slots 7 and 8, and the gNB reads its
    window from both.  Cut at the slot's end, as the port cut it before its
    window over slots (one slot's samples, 48783 of the 98304 the DFT
    takes), the window detects nothing."""
    fc, s = mu1["fc"], mu1["s"]
    info = fc.prach_info()
    total = fc.timing.cp.total
    assert (info.cp_samples, info.dft_size, total) == (12657, 98304, 61440)
    occ = tfc.prach_occasion_td(fc, 7, delay=128, amplitude=1.0)
    assert occ.shape == (2, total)
    energy = (np.abs(occ) ** 2).sum(-1)
    assert energy[1] > 0.4 * energy.sum()
    rx = mu1["x"]["ul"] + mu1["x"]["noise"]
    win = tfc._prach_windows(rx, fc, s)
    assert win.shape == (2, info.cp_samples + info.dft_size)
    assert win.untyped_storage().data_ptr() == rx.untyped_storage().data_ptr()
    assert torch.equal(win[1], rx[17:19].reshape(-1)[:win.shape[1]])
    for w, found in ((win, True), (win[:, :total], False)):
        det = tfc._prach_detect_batch(tfc.prach_mod.ofdm_demodulate_prach(w, info), fc)[2]
        assert bool(det[:, 7].all()) is found


def test_the_ul_slots_are_a_strided_view():
    fc = full_cell_config(tfc.FullCellConfig, config(MU1))
    x = torch.arange(40 * 3).reshape(40, 3)
    v = tfc._ul_view(x, fc, 40)
    assert v.data_ptr() == x[7].data_ptr()
    assert v.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    assert torch.equal(v.reshape(-1, 3), x[torch.as_tensor(fc.ul_slots(40))])
    full = tfc._dl_air(torch.ones(28, 4, dtype=torch.complex64), fc, 40)
    assert torch.equal(full[torch.as_tensor(fc.dl_slots(40))].real,
                       torch.ones(24, 4))
    assert not full[torch.as_tensor(fc.ul_slots(40))].any()


@pytest.mark.parametrize("fields, refused", [
    ({"srs_offset": 3}, "SRS occasion at slot 3 falls on a DL slot"),
    ({"csi_offset": 1}, "PUCCH F2 occasion at slot 1 falls on a DL slot"),
    ({"prach_offset": 5}, "PRACH occasion at slot 5 falls on a DL slot"),
    ({"ssb_period": 7}, "SSB occasion at slot 7 falls on a UL slot"),
    ({"csi_rs_offset": 8}, "CSI-RS occasion at slot 8 falls on a UL slot"),
    ({"csi_rs_offset": 6, "csi_rs_symbol": 8},
     "CSI-RS occasion at slot 6 falls on a special slot"),
    ({"prach_offset": 9, "csi_offset": 7}, "slot 9 runs onto the DL slot 10"),
    ({"tdd_period": 0}, "paired spectrum"),
    ({"tdd_dl_slots": 7, "tdd_ul_slots": 3}, "no slot is left"),
], ids=["srs", "f2", "prach", "ssb", "csi_rs_ul", "csi_rs_symbol",
        "prach_onto_dl", "paired_fields", "no_special"])
def test_a_pattern_or_occasion_that_does_not_fit_is_refused(fields, refused):
    with pytest.raises(ValueError, match=refused):
        full_cell_config(tfc.FullCellConfig, config(MU1, **fields))


@pytest.mark.parametrize("call, refused", [
    (lambda fc: fc.prach_slots(8), "PRACH occasion at slot 7 runs past the "
                                   "step's last slot 7"),
    (lambda fc: tfc.gnb_dl_slot_batch(None, None, None, None, fc, 20, device=CPU,
                                      mesh=object()), "runs on one device"),
    (lambda fc: tfc.gnb_ul_slot_batch_mimo(None, fc, 20, device=CPU, mesh=object()),
     "runs on one device"),
    (lambda fc: tfc.ue_ul_slot_batch(None, None, None, fc, 10, device=CPU,
                                     mesh=object()), "runs on one device"),
    (lambda fc: tfc.gnb_ul_slot_batch(torch.zeros(15, 61440, dtype=torch.complex64),
                                      fc, 15, device=CPU),
     "S=15 air slots is not a multiple of the TDD period 10"),
    (lambda fc: tfc.gnb_dl_slot_batch(None, None, None, None, fc, 25, device=CPU),
     "S=25 air slots is not a multiple of the TDD period 10"),
], ids=["prach_past_the_step", "mesh_dl", "mesh_ul_mimo", "mesh_ue", "s_not_periods_ul",
        "s_not_periods_dl"])
def test_a_call_that_the_tdd_path_does_not_take_is_refused(call, refused):
    fc = full_cell_config(tfc.FullCellConfig, config(MU1))
    with pytest.raises(ValueError, match=refused):
        call(fc)


@pytest.mark.parametrize("name", ["nr20_siso_4ue", "nr20_mimo2x2_4ue"])
def test_an_explicit_tdd_period_0_is_paired_spectrum(name):
    """The key given as 0 is the key left out: the same configuration and
    slots."""
    s = 10
    cfg = config(name)
    fc = full_cell_config(tfc.FullCellConfig, cfg)
    fc0 = full_cell_config(tfc.FullCellConfig, dict(cfg, tdd_period=0))
    assert fc0 == fc and hash(fc0) == hash(fc)
    every = list(range(s))
    assert fc0.dl_slots(s).tolist() == fc0.ul_slots(s).tolist() == every
    assert fc0.pdcch_slots(s).tolist() == every and fc0.special_slots(s).size == 0
    assert fc0.prach_span(24) == 1
    assert tfc.prach_occasion_td(fc0, 7).shape == (1, fc0.timing.cp.total)


def test_an_explicit_tdd_period_0_gives_the_paired_outputs():
    """The same outputs from the key given as 0 and left out, nothing
    counted and no TDD span opened."""
    s = 10
    cfg = config("nr20_siso_4ue")
    fc = full_cell_config(tfc.FullCellConfig, cfg)
    fc0 = full_cell_config(tfc.FullCellConfig, dict(cfg, tdd_period=0))
    x = draw_inputs(cfg, s, SNR_DB, SEED, CPU)
    dl_in = (x["pay_n"], x["pay_s"], x["dci"], x["pbch"])
    tracing.air_slots.clear()
    tracing.l1_tracer.enable()
    try:
        tds = [entry(tfc, f, "gnb_dl_slot_batch")(*dl_in, f, s, device=CPU)
               for f in (fc, fc0)]
        res = [entry(tfc, f, "gnb_ul_slot_batch")(x["ul"] + x["noise"], f, s,
                                                  soft_flat=True, device=CPU)
               for f in (fc, fc0)]
        names = {e["name"] for e in tracing.l1_tracer._events}
    finally:
        tracing.l1_tracer.disable()
        tracing.l1_tracer.clear()
    assert torch.equal(tds[0], tds[1])
    assert all(torch.equal(res[0][k], res[1][k]) for k in res[0])
    assert tracing.air_slots.snapshot() == {}
    assert "phy.dl" in names and not names & {"phy.dl.slots", "phy.ul.slots"}


def test_a_tdd_step_opens_the_slot_spans(cell):
    """Under a TDD pattern the DL call opens ``phy.dl.slots`` and the UL
    call ``phy.ul.slots``, each inside its direction's span."""
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in cell["events"]}
    for inner, outer in (("phy.dl.slots", "phy.dl"), ("phy.ul.slots", "phy.ul")):
        assert spans[outer][0] <= spans[inner][0] <= spans[inner][1] <= spans[outer][1]
