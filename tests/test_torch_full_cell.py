"""Parity of the port's full gNB slot (parallel/full_cell.py) with the JAX
reference at tests/test_full_cell.py's small_fc() (10 MHz, 52 PRB, 2 UEs),
S = 6 slots: one SSB (slot 0), PUCCH F2 CSI (1), SRS (3) and PRACH (5)
occasion.  Both packages get the same numpy-seeded payloads; the configs
cross over through ``convert``.

  * DL samples: within 1e-5 of the peak (FFT summation order; float32).
  * UL: both receivers get one rx — the JAX UE generator's samples plus
    numpy noise at 25 dB.  payload, tb_ok, the int8 carry, ACK bits, CSI
    bits, csi_ok, prach_detected and prach_delay are equal.  Floats:
    noise_var, srs_h, srs_snr_db, ack_metric and prach_metric within rtol
    1e-4 (relative to each output's peak), cfo within 1e-2 Hz absolute
    (float32 chains of FFT, estimator sums; the port's PRACH IDFT is
    torch.fft against the reference's IDFT matmul).
  * HARQ: the reference's carry, converted in the (S, U*C, n_cb) layout and
    in the flat (S*U*C, n_cb) one, chase-combined on a second reception.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.parallel import full_cell as jfc
from srsran_edgeric_5g_tpu_torch import convert
from srsran_edgeric_5g_tpu_torch.parallel import full_cell as tfc

# Six test workers share the host with the JAX tests: two intra-op threads.
torch.set_num_threads(2)

S = 6
RTOL = 1e-4
EXACT = ("payload", "tb_ok", "soft", "ack_bits", "csi_bits", "csi_ok",
         "prach_detected", "prach_delay")
CLOSE = ("noise_var", "srs_h", "srs_snr_db", "ack_metric", "prach_metric")


def small_fc() -> jfc.FullCellConfig:
    """tests/test_full_cell.py's small cell."""
    return jfc.FullCellConfig(
        nof_prb=52, nfft=1024, nof_ue=2, dl_first_prb=2, dl_prb_per_ue=20,
        ul_first_prb=2, ul_prb_per_ue=20, coreset_start_prb=2,
        coreset_nof_prb=48, ssb_first_subcarrier=192, prach_freq_prb=46)


@pytest.fixture(scope="module")
def cells():
    """Both packages' configs and results, the JAX reference computed once."""
    jc = small_fc()
    tc = convert.full_cell_from_dict(dataclasses.asdict(jc))
    u = jc.nof_ue
    rng = np.random.default_rng(0)
    ins = dict(
        pay_n=rng.integers(0, 2, (len(jc.norm_slots(S)), u,
                                  jc.dl_cell().derived_tbs()), dtype=np.int8),
        pay_s=rng.integers(0, 2, (len(jc.ssb_slots(S)), u,
                                  jc.dl_cell_ssb().derived_tbs()), dtype=np.int8),
        dci=rng.integers(0, 2, (S, 2 * u, jc.dci_bits), dtype=np.int8),
        pbch=rng.integers(0, 2, (len(jc.ssb_slots(S)), 24), dtype=np.int8),
        pay_u=rng.integers(0, 2, (S, u, jc.ul_cell().derived_tbs()), dtype=np.int8),
        ack=rng.integers(0, 2, (S, u, 2), dtype=np.int8),
        csi=rng.integers(0, 2, (len(jc.csi_slots(S)), u, jc.csi_bits), dtype=np.int8))
    dl = ("pay_n", "pay_s", "dci", "pbch")
    td_j = np.asarray(jax.jit(lambda *a: jfc.gnb_dl_slot_batch(*a, jc, S))(
        *(ins[k] for k in dl)))
    ue_j = np.asarray(jax.jit(lambda *a: jfc.ue_ul_slot_batch(*a, jc, S))(
        ins["pay_u"], ins["ack"], ins["csi"]))
    nv = float(np.mean(np.abs(ue_j) ** 2)) * 10 ** (-25 / 10)
    noise = rng.normal(size=ue_j.shape) + 1j * rng.normal(size=ue_j.shape)
    rx = (ue_j + noise * np.sqrt(nv / 2)).astype(np.complex64)
    ul = jax.jit(lambda x, soft, nd: jfc.gnb_ul_slot_batch(
        x, jc, S, soft_in=soft, new_data=nd))
    res_j = {k: np.asarray(v) for k, v in ul(jnp.asarray(rx), None, None).items()}
    zeros = jnp.zeros((S, u), jnp.float32)
    res2_j = {k: np.asarray(v) for k, v in
              ul(jnp.asarray(rx), jnp.asarray(res_j["soft"]), zeros).items()}
    res_t = {k: v.numpy() for k, v in
             tfc.gnb_ul_slot_batch(rx, tc, S, device="cpu").items()}
    return dict(jc=jc, tc=tc, ins=ins, td_j=td_j, ue_j=ue_j, rx=rx,
                res_j=res_j, res2_j=res2_j, res_t=res_t)


def test_dl_samples(cells):
    ins = cells["ins"]
    td_t = tfc.gnb_dl_slot_batch(ins["pay_n"], ins["pay_s"], ins["dci"],
                                 ins["pbch"], cells["tc"], S, device="cpu")
    td_j = cells["td_j"]
    assert td_t.dtype == torch.complex64 and td_t.shape == td_j.shape
    err = np.abs(td_t.numpy() - td_j).max() / np.abs(td_j).max()
    assert err < 1e-5, err


def test_ue_ul_samples(cells):
    ins = cells["ins"]
    ue_t = tfc.ue_ul_slot_batch(ins["pay_u"], ins["ack"], ins["csi"],
                                cells["tc"], S, device="cpu").numpy()
    err = np.abs(ue_t - cells["ue_j"]).max() / np.abs(cells["ue_j"]).max()
    assert err < 1e-5, err


@pytest.mark.parametrize("key", EXACT)
def test_ul_exact(cells, key):
    got, want = cells["res_t"][key], cells["res_j"][key]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", CLOSE)
def test_ul_close(cells, key):
    got, want = cells["res_t"][key], cells["res_j"][key]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def test_ul_cfo_and_recovery(cells):
    """cfo to 1e-2 Hz; and the reception itself is right: payload-exact,
    ACK / CSI exact, preamble 7 alone detected at its 24-sample delay."""
    res, ins = cells["res_t"], cells["ins"]
    np.testing.assert_allclose(res["cfo"], cells["res_j"]["cfo"], atol=1e-2)
    assert res["tb_ok"].all() and (res["payload"] == ins["pay_u"]).all()
    assert (res["ack_bits"] == ins["ack"]).all()
    assert res["csi_ok"].all() and (res["csi_bits"] == ins["csi"]).all()
    det = res["prach_detected"]
    assert det[:, 7].all() and det.sum() == det.shape[0]


@pytest.mark.parametrize("flat", [False, True])
def test_harq_carry_both_layouts(cells, flat):
    """The reference's carry through convert, chase-combined (new_data 0)
    on a second reception: payload, tb_ok and carry equal the reference's,
    in the layout given."""
    soft = cells["res_j"]["soft"]
    if flat:
        soft = soft.reshape(-1, soft.shape[-1])
    soft_t, _ = convert.harq_state_from_numpy(soft, cells["jc"].rntis(),
                                              device="cpu")
    assert soft_t.shape == soft.shape
    res = tfc.gnb_ul_slot_batch(cells["rx"], cells["tc"], S, soft_in=soft_t,
                                new_data=torch.zeros((S, 2)), soft_flat=flat,
                                device="cpu")
    want = cells["res2_j"]
    for key in ("payload", "tb_ok"):
        np.testing.assert_array_equal(res[key].numpy(), want[key])
    np.testing.assert_array_equal(res["soft"].numpy(),
                                  want["soft"].reshape(soft.shape))


def test_slot_occasion_slices():
    """The strided-slice forms of the reference's occasion selection and
    re-interleaving equal plain index selection, also for S not a multiple
    of the period."""
    for s_total in (6, 20, 23):
        x = torch.arange(s_total * 3).reshape(s_total, 3)
        occ = np.arange(0, s_total, 10)
        norm = np.asarray([i for i in range(s_total) if i % 10])
        assert torch.equal(tfc._slot_take(x, occ), x[occ])
        assert torch.equal(tfc._slot_take(x, np.arange(3, s_total, 10)),
                           x[np.arange(3, s_total, 10)])
        assert torch.equal(tfc._slot_drop_period(x, 10), x[norm])
        assert torch.equal(tfc._slot_merge_period(x[occ], x[norm], 10, s_total), x)
    with pytest.raises(ValueError):
        tfc._slot_take(x, np.asarray([0, 1, 5]))


def test_entry_points_need_cuda_or_cpu_request(cells):
    """The entry points run on the card by default: a host without CUDA
    raises instead of running on the CPU; the single-layer UL entry points
    refuse n_layers > 1 (the *_mimo ones take it)."""
    ins = cells["ins"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tfc.gnb_ul_slot_batch(cells["rx"], cells["tc"], S)
        with pytest.raises(RuntimeError):
            tfc.ue_ul_slot_batch(ins["pay_u"], ins["ack"], ins["csi"],
                                 cells["tc"], S)
    mimo = dataclasses.replace(cells["tc"], n_layers=2)
    with pytest.raises(ValueError, match="mimo"):
        tfc.gnb_ul_slot_batch(cells["rx"], mimo, S, device="cpu")
    with pytest.raises(ValueError, match="mimo"):
        tfc.ue_ul_slot_batch(ins["pay_u"], ins["ack"], ins["csi"], mimo, S,
                             device="cpu")
