"""The reference's TDD slot pattern and its PRACH window over slots, on the
CPU: srsRAN's default ``tdd_ul_dl_cfg`` (a period of 10 slots: 6 DL slots,
a special slot with 8 DL symbols, 3 UL slots) on each configuration's
cell, and a 100 MHz carrier at mu = 1 whose format-0 preamble spans two UL
slots.  Field defaults reproduce paired spectrum, the reference as it was.
"""

import json

import pytest
import torch

from phybench.chain import draw_inputs, full_cell_config
from phybench.reference import inputs
from phybench.reference.parallel import full_cell as rfc
from phybench.spec import ROOT, load_benchmark
from test_phybench_inputs import DIGESTS, digest

S = 10
SEED = 2 ** 31 + 4099
SNR_DB = 25.0
SRSRAN = {"tdd_period": 10, "tdd_dl_slots": 6, "tdd_dl_symbols": 8,
          "tdd_ul_slots": 3, "tdd_ul_symbols": 0}
# The occasions moved onto slots of their kind: CSI-RS on the special slot
# 6, PRACH on 7 (7 and 8 at mu = 1), SRS on 8, PUCCH F2 on 9.
OCCASIONS = {"csi_rs_offset": 6, "prach_offset": 7, "srs_offset": 8,
             "csi_period": 10, "csi_offset": 9}
DL, SPECIAL, UL = [0, 1, 2, 3, 4, 5], [6], [7, 8, 9]
CONFIGS = {c["name"]: c["file"] for c in load_benchmark()["configs"]}
CPU = torch.device("cpu")


def config(name: str, **fields) -> dict:
    return dict(json.loads((ROOT / CONFIGS[name]).read_text()), **fields)


def entry(fc, name: str):
    return getattr(rfc, name + ("_mimo" if fc.n_layers > 1 else ""))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(DIGESTS))
def cell(request):
    """One configuration's cell under srsRAN's pattern and in paired
    spectrum: the TDD inputs, its DL samples and UL results, and the paired
    DL fed the same bits on the slots that both send."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = config(request.param, **OCCASIONS, **SRSRAN)
    cfg_pair = config(request.param, **OCCASIONS)
    fc = full_cell_config(rfc.FullCellConfig, cfg)
    fc_pair = full_cell_config(rfc.FullCellConfig, cfg_pair)
    x = draw_inputs(cfg, S, SNR_DB, SEED, CPU)
    gen = torch.Generator().manual_seed(SEED)
    xp = {k: torch.randint(0, 2, shape, generator=gen, dtype=torch.int8)
          for k, shape in inputs.shapes(fc_pair, S).items()}
    # The paired step's normal slots are 1..9, the TDD step's 1..5; its
    # PDCCH slots 0..9, the TDD step's 0..6; both have SSB on slot 0.
    xp["pay_n"][:5] = x["pay_n"]
    xp["dci"][:7] = x["dci"]
    xp["pay_s"], xp["pbch"] = x["pay_s"], x["pbch"]
    dl = [entry(f, "gnb_dl_slot_batch")(v["pay_n"], v["pay_s"], v["dci"],
                                         v["pbch"], f, S, device=CPU)
          for f, v in ((fc, x), (fc_pair, xp))]
    res = entry(fc, "gnb_ul_slot_batch")(x["ul"] + x["noise"], fc, S,
                                         soft_flat=True, device=CPU)
    torch.set_num_threads(n)
    return {"fc": fc, "x": x, "td": dl[0], "td_pair": dl[1], "res": res}


def test_full_dl_slots_equal_the_paired_step_and_the_rest_is_silent(cell):
    fc, td, td_pair = cell["fc"], cell["td"], cell["td_pair"]
    assert fc.dl_slots(S).tolist() == DL
    assert fc.special_slots(S).tolist() == SPECIAL
    assert fc.ul_slots(S).tolist() == UL
    assert td.shape == td_pair.shape and td.shape[0] == S
    assert torch.equal(td[DL], td_pair[DL])
    assert td[DL].abs().amax(-1).min() > 0
    assert not td[UL].any()
    # The special slot: PDCCH on symbol 0 and CSI-RS on symbol 1, as the
    # paired slot 6 has them; no PDSCH from symbol 2, nothing after its 8
    # DL symbols.
    starts = fc.timing.cp.starts
    head = starts[2]
    assert torch.equal(td[6, ..., :head], td_pair[6, ..., :head])
    assert td[6, ..., :head].abs().amax() > 0
    assert not td[6, ..., head:].any()
    assert starts[8] > head


def test_ul_round_trip_decodes_every_ul_slot(cell):
    fc, x, res = cell["fc"], cell["x"], cell["res"]
    u = fc.nof_ue
    assert not x["ul"][DL + SPECIAL].any()
    assert x["ul"][UL].abs().amax(-1).min() > 0
    assert res["payload"].shape == x["pay_u"].shape
    assert res["payload"].shape[:2] == (len(UL), u)
    assert res["tb_ok"].shape == (len(UL), u)
    assert res["ack_bits"].shape == (len(UL), u, 2)
    c = rfc.sp._plans(fc.ul_cell(), 0)[0].c
    assert res["soft"].shape[0] == len(UL) * u * c
    assert res["tb_ok"].all()
    assert torch.equal(res["payload"], x["pay_u"])
    assert torch.equal(res["ack_bits"], x["ack"])
    assert torch.equal(res["csi_bits"], x["csi"]) and res["csi_ok"].all()
    assert res["srs_snr_db"].shape == (1, u)
    assert res["prach_detected"].shape == (1, 64)
    assert res["prach_detected"][0].nonzero().flatten().tolist() == [7]


def test_the_inputs_take_the_patterns_shapes(cell):
    fc, x = cell["fc"], cell["x"]
    u = fc.nof_ue
    want = inputs.shapes(fc, S)
    assert [k for k in want] == ["pay_n", "pay_s", "dci", "pbch", "pay_u",
                                 "ack", "csi"]
    assert want["pay_n"][0] == 5 and want["pay_s"][0] == 1
    assert want["dci"] == (len(DL + SPECIAL), 2 * u, fc.dci_bits)
    assert want["pbch"] == (1, 24)
    assert want["pay_u"][:2] == (len(UL), u) and want["ack"] == (len(UL), u, 2)
    assert want["csi"] == (1, u, fc.csi_bits)
    assert {k: tuple(x[k].shape) for k in want} == want
    assert tuple(x["ones"].shape) == (len(UL), u)


def test_the_snr_is_the_traffics_on_the_ul_slots(cell):
    """The AWGN is set against the UL slots' power, not a mean that the
    silent slots pull down (that would read 25 + 10 log10(10/3) dB)."""
    x = cell["x"]
    ul = x["ul"][UL]
    sig = (ul.real ** 2 + ul.imag ** 2).mean()
    noise = (x["noise"].real ** 2 + x["noise"].imag ** 2).mean()
    assert abs(10 * torch.log10(sig / noise).item() - SNR_DB) < 0.1


@pytest.mark.parametrize("fields, refused", [
    ({"srs_offset": 3}, "SRS occasion at slot 3 falls on a DL slot"),
    ({"csi_offset": 1}, "PUCCH F2 occasion at slot 1 falls on a DL slot"),
    ({"prach_offset": 5}, "PRACH occasion at slot 5 falls on a DL slot"),
    ({"ssb_period": 7}, "SSB occasion at slot 7 falls on a UL slot"),
    ({"csi_rs_offset": 8}, "CSI-RS occasion at slot 8 falls on a UL slot"),
    ({"csi_rs_offset": 6, "csi_rs_symbol": 8},
     "CSI-RS occasion at slot 6 falls on a special slot"),
    ({"tdd_period": 0}, "paired spectrum"),
    ({"tdd_dl_slots": 7, "tdd_ul_slots": 3}, "no slot is left"),
])
def test_an_occasion_on_a_slot_of_the_wrong_kind_is_refused(fields, refused):
    cfg = config("nr20_siso_4ue", **{**OCCASIONS, **SRSRAN, **fields})
    with pytest.raises(ValueError, match=refused):
        full_cell_config(rfc.FullCellConfig, cfg)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_defaults_are_paired_spectrum_as_it_was(name):
    """An explicit ``tdd_period`` 0 is the key left out: the same
    configuration, slots, shapes and bits."""
    torch.set_num_threads(2)
    cfg = config(name)
    fc = full_cell_config(rfc.FullCellConfig, cfg)
    fc0 = full_cell_config(rfc.FullCellConfig, dict(cfg, tdd_period=0))
    assert fc0 == fc
    every = list(range(S))
    assert fc.dl_slots(S).tolist() == fc.ul_slots(S).tolist() == every
    assert fc.special_slots(S).tolist() == []
    assert fc.pdcch_slots(S).tolist() == every
    assert fc.prach_span(24) == 1
    for slots in ("ssb_slots", "norm_slots", "csi_slots", "srs_slots",
                  "prach_slots", "csi_rs_slots"):
        assert getattr(fc0, slots)(S).tolist() == getattr(fc, slots)(S).tolist()
    assert inputs.shapes(fc0, S) == inputs.shapes(fc, S)
    x = draw_inputs(dict(cfg, tdd_period=0), S, SNR_DB, 2 ** 31 + 77, CPU)
    assert digest(x) == DIGESTS[name]


# ---------------------------------------------------------------- mu = 1

MU1 = dict(OCCASIONS, **SRSRAN, nof_prb=273, nfft=4096, mu=1,
           ul_prb_per_ue=64, prach_freq_prb=262)
S_MU1 = 20


@pytest.fixture(scope="module")
def mu1():
    """A 100 MHz carrier (273 PRB, nfft 4096, 122.88 Msps) under srsRAN's
    pattern, PUSCH 64 PRB per UE from PRB 4, clear of the F2 and PRACH
    PRBs from 262: the inputs and UL results at the harness's PRACH delay
    (1.04 us, 128 samples), and the UL results at a delay of 24 samples."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = config("nr20_siso_4ue", **MU1)
    fc = full_cell_config(rfc.FullCellConfig, cfg)
    x = draw_inputs(cfg, S_MU1, SNR_DB, SEED, CPU)
    res = rfc.gnb_ul_slot_batch(x["ul"] + x["noise"], fc, S_MU1,
                                soft_flat=True, device=CPU)
    ul24 = rfc.ue_ul_slot_batch(x["pay_u"], x["ack"], x["csi"], fc, S_MU1,
                                prach_delay=24, device=CPU)
    res24 = rfc.gnb_ul_slot_batch(ul24 + x["noise"], fc, S_MU1,
                                  soft_flat=True, device=CPU)
    torch.set_num_threads(n)
    return {"fc": fc, "x": x, "res": res, "res24": res24}


def test_a_preamble_over_two_ul_slots_is_detected_at_mu_1(mu1):
    """The format-0 preamble (12657 + 98304 samples) spans UL slots 7 and 8
    of the 61440-sample slots, and preamble 7 is detected in both
    occasions, alone at the harness's delay and at a delay of 24 samples
    too; every TB decodes.  The reference before its PRACH window over
    slots cut the preamble at the slot's end: on a paired carrier of these
    sizes, from this seed, it read peak metrics of 1.96 and 3.57 for
    preamble 7 against the threshold of 20, and detected nothing."""
    fc, x, res = mu1["fc"], mu1["x"], mu1["res"]
    info = fc.prach_info()
    assert (info.cp_samples, info.dft_size, fc.timing.cp.total) == (12657, 98304, 61440)
    assert fc.prach_span(128) == fc.prach_span(24) == 2
    assert fc.prach_slots(S_MU1, 128).tolist() == [7, 17]
    assert res["payload"].shape[:2] == (6, fc.nof_ue)
    assert res["tb_ok"].all() and torch.equal(res["payload"], x["pay_u"])
    assert torch.equal(res["ack_bits"], x["ack"])
    det = res["prach_detected"]
    assert [d.nonzero().flatten().tolist() for d in det] == [[7], [7]]
    assert (res["prach_metric"][:, 7] > fc.prach_threshold).all()
    res24 = mu1["res24"]
    assert res24["prach_detected"][:, 7].all()
    assert res24["prach_delay"][:, 7].tolist() == [0, 0]


def test_the_mu_1_preamble_reads_the_mu_0_cells_delay(mu1, cell):
    """The same path (1.04 us: 24 samples at 23.04 Msps, 128 at 122.88)
    reads the same delay in the L_RA domain at both rates."""
    assert cell["res"]["prach_delay"][:, 7].tolist() == [1]
    assert mu1["res"]["prach_delay"][:, 7].tolist() == [1, 1]


@pytest.mark.parametrize("s, refused", [
    (8, "PRACH occasion at slot 7 runs past the step's last slot 7"),
    (20, None),
])
def test_a_preamble_past_the_step_is_refused(s, refused):
    fc = full_cell_config(rfc.FullCellConfig, config("nr20_siso_4ue", **MU1))
    if refused is None:
        assert fc.prach_slots(s).tolist() == [7, 17]
        return
    with pytest.raises(ValueError, match=refused):
        fc.prach_slots(s)


def test_a_preamble_onto_a_dl_slot_is_refused():
    cfg = config("nr20_siso_4ue", **dict(MU1, prach_offset=9, csi_offset=7))
    with pytest.raises(ValueError, match="slot 9 runs onto the DL slot 10"):
        full_cell_config(rfc.FullCellConfig, cfg)
