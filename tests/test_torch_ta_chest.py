"""Parity of the port's time-alignment estimator (ops/ta_estimator.py) and
TA + smoothing channel estimator (ops/channel_est.estimate_port_ta) with
the JAX reference, on the same numpy-seeded inputs.

  * estimate_ta: within 1e-2 of one IDFT bin (1 / (4096 * scs) s); the
    peak search is an argmax over float32 powers, the interpolation a
    float32 parabola.
  * estimate_port_ta: h within rtol 1e-4 of its peak, noise_var and cfo
    within rtol 1e-4, TA within 1e-2 of one IDFT bin (float32 window IDFT
    products and smoother products summed in another order).
  * The SISO ul_slot_batch with delay_spread_us = 1.0 at
    tests/test_torch_slot_pipeline.py's small cell, through a two-sample
    delay: payload and tb_ok equal, noise_var rtol 1e-4, cfo within 1e-2 Hz,
    a ±1 wire-LLR step in at most 1e-3 of the entries (and the carry only
    there).
  * The 256QAM r682.5/1024 small full cell with ul_delay_spread_us = 1.0 at
    33 dB (bench.py's --qam256 point at the small cell): every bit-level
    output equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.ops import channel_est as jce
from srsran_edgeric_5g_tpu.ops import ta_estimator as jta
from srsran_edgeric_5g_tpu.parallel import full_cell as jfc
from srsran_edgeric_5g_tpu.parallel import slot_pipeline as jsp
from srsran_edgeric_5g_tpu_torch import convert
from srsran_edgeric_5g_tpu_torch.ops import channel_est as tce
from srsran_edgeric_5g_tpu_torch.ops import ta_estimator as tta
from srsran_edgeric_5g_tpu_torch.parallel import full_cell as tfc
from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as tsp

# Six test workers share the host with the JAX tests: two intra-op threads.
torch.set_num_threads(2)

RTOL = 1e-4
SCS = 15e3
RNTIS = (0x4601 + np.arange(4)).astype(np.uint32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _multipath(rng, batch, k, delays_s, scs):
    """(batch, len(k)) frequency response of random taps at ``delays_s``."""
    taps = (rng.normal(size=(batch, len(delays_s)))
            + 1j * rng.normal(size=(batch, len(delays_s)))) / np.sqrt(2)
    ph = np.exp(-2j * np.pi * scs * np.outer(k, delays_s))   # (K, taps)
    return taps @ ph.T


@pytest.mark.parametrize("max_ta_s", [None, 2.5e-6])
def test_estimate_ta(max_ta_s):
    rng = np.random.default_rng(1)
    nsubc, scs = 120, 2 * SCS
    ta = rng.uniform(-1.5e-6, 1.5e-6, size=32)
    k = np.arange(nsubc)
    h = np.exp(-2j * np.pi * scs * np.outer(ta, k))
    h = h + 0.1 * (rng.normal(size=h.shape) + 1j * rng.normal(size=h.shape))
    h = h.astype(np.complex64)
    want = np.asarray(jta.estimate_ta(jnp.asarray(h), scs, max_ta_s=max_ta_s))
    got = tta.estimate_ta(torch.as_tensor(h), scs, max_ta_s=max_ta_s)
    assert got.dtype == torch.float32 and got.shape == want.shape
    bin_s = 1.0 / (jta.DFT_SIZE * scs)
    assert np.abs(got.numpy() - want).max() <= 1e-2 * bin_s
    # And the estimate is the delay, to within the parabola's bias on a
    # sinc-squared peak (under half a bin).
    assert np.abs(want - ta).max() < 0.5 * bin_s


@pytest.mark.parametrize("delay_spread_s", [None, 1e-6])
@pytest.mark.parametrize("ndmrs", [1, 2])
def test_estimate_port_ta(delay_spread_s, ndmrs):
    rng = np.random.default_rng(2 + ndmrs)
    batch, npil, nsubc = 24, 120, 240
    pil_k = np.arange(0, nsubc, 2)
    h = _multipath(rng, batch, pil_k, [0.4e-6, 0.9e-6, 1.3e-6], SCS)
    ref = ((1 - 2 * rng.integers(0, 2, (batch, ndmrs, npil)))
           + 1j * (1 - 2 * rng.integers(0, 2, (batch, ndmrs, npil)))) / np.sqrt(2)
    times = np.asarray([2 * 1096, 11 * 1096]) / 15.36e6
    cfo_rot = np.exp(2j * np.pi * 150.0 * times[:ndmrs])
    rx = h[:, None] * ref * cfo_rot[None, :, None]
    rx = rx + 0.05 * (rng.normal(size=rx.shape) + 1j * rng.normal(size=rx.shape))
    rx, ref = rx.astype(np.complex64), ref.astype(np.complex64)
    t_opt = times[:ndmrs] if ndmrs > 1 else None
    want = [np.asarray(a) for a in jce.estimate_port_ta(
        jnp.asarray(rx), jnp.asarray(ref), pil_k, nsubc, SCS,
        dmrs_symbol_times_s=t_opt, delay_spread_s=delay_spread_s)]
    got = [a.numpy() for a in tce.estimate_port_ta(
        torch.as_tensor(rx), torch.as_tensor(ref), pil_k, nsubc, SCS,
        dmrs_symbol_times_s=t_opt, delay_spread_s=delay_spread_s)]
    assert got[0].dtype == np.complex64 and got[1].dtype == np.float32
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)
    bin_s = 1.0 / (jta.DFT_SIZE * 2 * SCS)
    assert np.abs(got[3] - want[3]).max() <= 1e-2 * bin_s


def test_freq_smooth_and_matrix():
    """The smoother's operator and its edge-extended product."""
    rng = np.random.default_rng(4)
    h = (rng.normal(size=(6, 60)) + 1j * rng.normal(size=(6, 60))).astype(np.complex64)
    np.testing.assert_array_equal(tce._smooth_matrix(60, 0.8e-6, 30e3),
                                  jce._smooth_matrix(60, 0.8e-6, 30e3))
    want = np.asarray(jce._freq_smooth(jnp.asarray(h), 0.8e-6, 30e3))
    _close(tce._freq_smooth(torch.as_tensor(h), 0.8e-6, 30e3).numpy(), want)


def test_ul_slot_batch_ta_estimator():
    """The SISO pipeline's delay_spread_us > 0 branch: both receivers on one
    rx, delayed by two samples."""
    jc = jsp.CellConfig(nof_prb=52, nfft=768, nof_ue=4, prb_per_ue=12,
                        modulation="qam16", target_rate=0.4, delay_spread_us=1.0)
    tc = convert.cell_from_dict(dataclasses.asdict(jc))
    assert tc.delay_spread_us == 1.0
    rng = np.random.default_rng(6)
    s = 2
    pay = rng.integers(0, 2, (s, 4, jc.derived_tbs()), dtype=np.int8)
    td = np.asarray(jax.jit(lambda p: jsp.dl_slot_batch(
        p, jnp.asarray(RNTIS), jc))(jnp.asarray(pay)))
    td = np.roll(td, 2, axis=-1)
    nv = float(np.mean(np.abs(td) ** 2)) * 10 ** (-20 / 10)
    rx = (td + (rng.normal(size=td.shape) + 1j * rng.normal(size=td.shape))
          * np.sqrt(nv / 2)).astype(np.complex64)
    res_j, llr_j = jax.jit(lambda x: (jsp.ul_slot_batch(x, jnp.asarray(RNTIS), jc),
                                      jsp._ul_front(x, jnp.asarray(RNTIS), jc)[0]))(
        jnp.asarray(rx))
    res_j, llr_j = [np.asarray(a) for a in res_j], np.asarray(llr_j)
    res_t = [a.numpy() for a in tsp.ul_slot_batch(rx, RNTIS.astype(np.int64), tc,
                                                  device="cpu")]
    assert res_j[1].all() and (res_j[0] == pay).all()
    np.testing.assert_array_equal(res_t[0], res_j[0])
    np.testing.assert_array_equal(res_t[1], res_j[1])
    np.testing.assert_allclose(res_t[2], res_j[2], rtol=RTOL)
    np.testing.assert_allclose(res_t[3], res_j[3], atol=1e-2)
    llr_t = tsp._ul_front(torch.as_tensor(rx), torch.as_tensor(RNTIS.astype(np.int64)),
                          tc)[0].numpy()
    llr_diff = int((llr_t != llr_j).sum())
    assert np.abs(llr_t - llr_j).max(initial=0) <= 1
    assert llr_diff <= 1e-3 * llr_j.size
    soft_diff = np.abs(res_t[4].astype(int) - res_j[4].astype(int))
    assert soft_diff.max(initial=0) <= 1 and (soft_diff > 0).sum() <= llr_diff


def test_qam256_full_cell_ta_estimator():
    """bench.py's --qam256 point (256QAM r682.5/1024 both ways, TA +
    smoothing PUSCH estimator, 33 dB) at the small full cell, S = 6: the
    UE UL through the JAX package, one rx for both receivers."""
    s = 6
    jc = jfc.FullCellConfig(
        nof_prb=52, nfft=1024, nof_ue=2, dl_first_prb=2, dl_prb_per_ue=20,
        ul_first_prb=2, ul_prb_per_ue=20, coreset_start_prb=2,
        coreset_nof_prb=48, ssb_first_subcarrier=192, prach_freq_prb=46,
        dl_modulation="qam256", ul_modulation="qam256",
        dl_target_rate=682.5 / 1024, ul_target_rate=682.5 / 1024,
        ul_delay_spread_us=1.0)
    tc = convert.full_cell_from_dict(dataclasses.asdict(jc))
    assert tc.ul_cell().delay_spread_us == 1.0
    u = jc.nof_ue
    rng = np.random.default_rng(7)
    pay_u = rng.integers(0, 2, (s, u, jc.ul_cell().derived_tbs()), dtype=np.int8)
    ack = rng.integers(0, 2, (s, u, 2), dtype=np.int8)
    csi = rng.integers(0, 2, (len(jc.csi_slots(s)), u, jc.csi_bits), dtype=np.int8)
    ue = np.asarray(jax.jit(lambda *a: jfc.ue_ul_slot_batch(*a, jc, s))(
        pay_u, ack, csi))
    ue_t = tfc.ue_ul_slot_batch(pay_u, ack, csi, tc, s, device="cpu").numpy()
    assert np.abs(ue_t - ue).max() <= 1e-5 * np.abs(ue).max()
    nv = float(np.mean(np.abs(ue) ** 2)) * 10 ** (-33 / 10)
    rx = (ue + (rng.normal(size=ue.shape) + 1j * rng.normal(size=ue.shape))
          * np.sqrt(nv / 2)).astype(np.complex64)
    res_j = {k: np.asarray(v) for k, v in jax.jit(
        lambda x: jfc.gnb_ul_slot_batch(x, jc, s))(jnp.asarray(rx)).items()}
    res_t = {k: v.numpy() for k, v in
             tfc.gnb_ul_slot_batch(rx, tc, s, device="cpu").items()}
    assert res_j["tb_ok"].all() and (res_j["payload"] == pay_u).all()
    for key in ("payload", "tb_ok", "soft", "ack_bits", "csi_bits", "csi_ok",
                "prach_detected", "prach_delay"):
        np.testing.assert_array_equal(res_t[key], res_j[key], err_msg=key)
    _close(res_t["noise_var"], res_j["noise_var"])
    np.testing.assert_allclose(res_t["cfo"], res_j["cfo"], atol=1e-2)
