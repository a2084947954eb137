"""Parity of the port's symbol-level ops with the JAX reference: modulation,
soft demapping, wire quantisation, DM-RS, channel estimation, MMSE
equalisation and OFDM.

Tolerances: these are float32 computations whose operation order can differ
(FFT library, complex exponential, summation order), so they compare at
rtol 1e-5 of the largest magnitude (float32 epsilon is 1.2e-7; a 768/1536-
point FFT and the equaliser's sums accumulate a few hundred ulps at most).
Bit-valued outputs (modulation of bits, DM-RS, quantised LLRs of identical
float inputs) compare exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.ops import channel_est as jce
from srsran_edgeric_5g_tpu.ops import dmrs as jdmrs
from srsran_edgeric_5g_tpu.ops import equalizer as jeq
from srsran_edgeric_5g_tpu.ops import modulation as jmod
from srsran_edgeric_5g_tpu.ops import ofdm as jofdm
from srsran_edgeric_5g_tpu.ran.numerology import slot_timing as jslot_timing
from srsran_edgeric_5g_tpu_torch.ops import channel_est as tce
from srsran_edgeric_5g_tpu_torch.ops import dmrs as tdmrs
from srsran_edgeric_5g_tpu_torch.ops import equalizer as teq
from srsran_edgeric_5g_tpu_torch.ops import modulation as tmod
from srsran_edgeric_5g_tpu_torch.ops import ofdm as tofdm
from srsran_edgeric_5g_tpu_torch.ran.numerology import slot_timing

# Six test workers share the host with the JAX tests: two intra-op threads.
torch.set_num_threads(2)

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_array_less(np.abs(got - want).max(), rtol * scale + 1e-30)


def _cplx(rng, shape, scale=1.0):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape)) * scale
            ).astype(np.complex64)


@pytest.mark.parametrize("mod", ["bpsk", "qpsk", "qam16", "qam64", "qam256"])
def test_modulate_demodulate(mod):
    qm = jmod.QM[mod]
    rng = np.random.default_rng(qm)
    bits = rng.integers(0, 2, (3, 60 * qm), dtype=np.int8)
    sj = np.asarray(jmod.modulate(jnp.asarray(bits), mod))
    st = tmod.modulate(torch.as_tensor(bits), mod)
    assert st.dtype == torch.complex64
    np.testing.assert_array_equal(st.numpy(), sj)

    y = (sj + _cplx(rng, sj.shape, 0.05)).astype(np.complex64)
    nv = rng.uniform(0.005, 0.05, sj.shape).astype(np.float32)
    nv[0, :3] = 0.0                                   # zero noise -> rcp 0
    lj = np.array(jmod.demodulate_soft(jnp.asarray(y), jnp.asarray(nv), mod,
                                         quantize=False))
    lt = tmod.demodulate_soft(torch.as_tensor(y), torch.as_tensor(nv), mod,
                              quantize=False).numpy()
    _close(lt, lj)
    # Quantisation of IDENTICAL float LLRs is exact (round half to even in
    # both frameworks).
    np.testing.assert_array_equal(
        tmod.wire_quantize(torch.as_tensor(lj), mod).numpy(),
        np.asarray(jmod.wire_quantize(jnp.asarray(lj), mod)))
    rl = jmod.RANGE_LIMIT_PSK if qm <= 2 else jmod.RANGE_LIMIT
    np.testing.assert_array_equal(
        tmod.quantize_llrs(torch.as_tensor(lj), rl).numpy(),
        np.asarray(jmod.quantize_llrs(jnp.asarray(lj), rl)))
    # demodulate_soft(quantize=True) end to end: a float32 LLR within float
    # error of a rounding boundary may land one step apart.
    qj = np.asarray(jmod.demodulate_soft(jnp.asarray(y), jnp.asarray(nv), mod))
    qt = tmod.demodulate_soft(torch.as_tensor(y), torch.as_tensor(nv), mod).numpy()
    assert qt.dtype == np.int8
    diff = np.abs(qt.astype(int) - qj.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_wire_quantize_half_to_even():
    x = torch.tensor([0.25 / 6, 0.5 / 6, 1.5 / 6, 2.5 / 6, -2.5 / 6, 100.0, -100.0])
    got = tmod.wire_quantize(x, "qam64")
    want = np.asarray(jmod.wire_quantize(jnp.asarray(x.numpy()), "qam64"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dmrs():
    for slot, sym, nid in [(0, 2, 1), (7, 11, 1007), (19, 0, 0)]:
        assert tdmrs.dmrs_c_init(slot, sym, nid) == jdmrs.dmrs_c_init(slot, sym, nid)
    for ct, prb, port in [(1, 26, 0), (1, 12, 1), (1, 4, 3), (2, 6, 2), (2, 5, 5)]:
        a, b = jdmrs.dmrs_pattern(ct, prb, port), tdmrs.dmrs_pattern(ct, prb, port)
        np.testing.assert_array_equal(a.subcarriers, b.subcarriers)
        np.testing.assert_array_equal(a.wf, b.wf)
        assert a.delta == b.delta
    ci = np.array([tdmrs.dmrs_c_init(0, 2, 1), 12345, 2 ** 31 - 1])
    for skip in (0, 18):
        np.testing.assert_array_equal(
            tdmrs.dmrs_sequence(torch.as_tensor(ci), 636, skip).numpy(),
            np.asarray(jdmrs.dmrs_sequence(jnp.asarray(ci.astype(np.uint32)),
                                           636, skip)))


@pytest.mark.parametrize("ndmrs", [1, 2, 3])
def test_estimate_port(ndmrs):
    rng = np.random.default_rng(ndmrs)
    npil, nsubc = 156, 312
    pat = tdmrs.dmrs_pattern(1, nsubc // 12, 0)
    ref = np.exp(1j * rng.uniform(0, 2 * np.pi, (6, ndmrs, npil))).astype(np.complex64)
    h = _cplx(rng, (6, 1, npil))
    cfo = rng.uniform(-200, 200, (6, 1, 1))
    times = np.arange(ndmrs) * 6.4e-4 + 1e-4
    rot = np.exp(2j * np.pi * cfo * times[None, :, None])
    rx = (h * ref * rot + _cplx(rng, (6, ndmrs, npil), 0.05)).astype(np.complex64)
    t_opt = times if ndmrs > 1 else None
    hj, nvj, cfoj = jce.estimate_port(jnp.asarray(rx), jnp.asarray(ref),
                                      pat.subcarriers, nsubc,
                                      dmrs_symbol_times_s=t_opt)
    ht, nvt, cfot = tce.estimate_port(torch.as_tensor(rx), torch.as_tensor(ref),
                                      pat.subcarriers, nsubc,
                                      dmrs_symbol_times_s=t_opt)
    assert ht.dtype == torch.complex64 and nvt.dtype == torch.float32
    _close(ht.numpy(), hj)
    _close(nvt.numpy(), nvj)
    # CFO = angle / (2 pi dt): |d angle| ~ 1e-6 rad -> ~1e-3 Hz at dt 0.64 ms.
    np.testing.assert_allclose(cfot.numpy(), np.asarray(cfoj), atol=1e-2)
    # cfo_correlation / ls_estimate on their own
    _close(tce.cfo_correlation(torch.as_tensor(rx)).numpy(),
           jce.cfo_correlation(jnp.asarray(rx)))
    _close(tce.ls_estimate(torch.as_tensor(rx), torch.as_tensor(ref)).numpy(),
           jce.ls_estimate(jnp.asarray(rx), jnp.asarray(ref)))
    if ndmrs > 1:
        np.testing.assert_allclose(
            tce.cfo_estimate(torch.as_tensor(rx), 6.4e-4).numpy(),
            np.asarray(jce.cfo_estimate(jnp.asarray(rx), 6.4e-4)), atol=1e-2)


def test_equalize_mmse_1xn_abnormal_inputs():
    """Including zero / infinite / NaN channels and zero / negative / inf
    noise: excluded ports, erased REs (x 0, nvar +inf)."""
    rng = np.random.default_rng(11)
    ports, n = 3, 40
    y = _cplx(rng, (ports, 2, n))
    h = _cplx(rng, (ports, 2, n))
    nv = rng.uniform(0.01, 0.1, (ports, 2, n)).astype(np.float32)
    h[0, 0, :5] = 0
    h[:, 0, 5] = 0                                   # no usable port at all
    h[1, 1, 6] = np.inf
    h[2, 1, 7] = np.nan
    nv[0, 1, 8] = 0.0
    nv[:, 1, 9] = 0.0                                # zero noise on every port
    nv[1, 0, 10] = -1.0
    nv[2, 0, 11] = np.inf
    for scale in (1.0, 0.5):
        xj, vj = jeq.equalize_mmse_1xn(jnp.asarray(y), jnp.asarray(h),
                                       jnp.asarray(nv), scale)
        xt, vt = teq.equalize_mmse_1xn(torch.as_tensor(y), torch.as_tensor(h),
                                       torch.as_tensor(nv), scale)
        xj, vj = np.asarray(xj), np.asarray(vj)
        assert xt.dtype == torch.complex64 and vt.dtype == torch.float32
        np.testing.assert_array_equal(np.isinf(vt.numpy()), np.isinf(vj))
        np.testing.assert_array_equal(xt.numpy() == 0, xj == 0)
        fin = np.isfinite(vj)
        _close(vt.numpy()[fin], vj[fin])
        _close(xt.numpy(), xj)
    assert np.isinf(vt.numpy()[0, 5]) and xt.numpy()[0, 5] == 0


@pytest.mark.parametrize("nof_prb,nfft,fc,offset", [
    (52, 768, 0.0, 0), (106, 1536, 0.0, 0), (52, 768, 3.5e9, 0),
    (25, 512, 0.0, 9)])
def test_ofdm(nof_prb, nfft, fc, offset):
    tj, tt = jslot_timing(nof_prb, nfft), slot_timing(nof_prb, nfft)
    rng = np.random.default_rng(nfft)
    grid = _cplx(rng, (2, tt.nsymb, tt.nof_subc))
    sj = np.asarray(jofdm.modulate_slot(jnp.asarray(grid), tj, fc, scale=1.0 / nfft))
    st = tofdm.modulate_slot(torch.as_tensor(grid), tt, fc, scale=1.0 / nfft)
    assert st.dtype == torch.complex64 and st.shape[-1] == tt.cp.total
    _close(st.numpy(), sj)
    noisy = (sj + _cplx(rng, sj.shape, 1e-3)).astype(np.complex64)
    gj = np.asarray(jofdm.demodulate_slot(jnp.asarray(noisy), tj, fc, scale=1.0,
                                          window_offset=offset))
    gt = tofdm.demodulate_slot(torch.as_tensor(noisy), tt, fc, scale=1.0,
                               window_offset=offset)
    _close(gt.numpy(), gj)
    # Round trip of the port alone (default 1/nfft demod scale at scale 1).
    back = tofdm.demodulate_slot(tofdm.modulate_slot(torch.as_tensor(grid), tt), tt)
    _close(back.numpy(), grid)
