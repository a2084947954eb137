"""The port's channel emulator (ops/channel_model.py) against the JAX
reference: the deterministic functions on the same inputs (CFO ramp,
delay, TDL tap layout and FIR, HST Doppler trajectory and ramp, RLF
blanking) within 2e-6 of the peak (float32 phase ramps evaluated by two
libraries), and the random ones (AWGN, TDL tap draws), which take a
torch.Generator, against their stated statistics."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.ops import channel_model as jcm
from srsran_edgeric_5g_tpu_torch.ops import channel_model as tcm

torch.set_num_threads(2)
SRATE = 11.52e6


def _x(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _peak_close(got, want, tol=2e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_deterministic_functions_match_reference():
    rng = np.random.default_rng(0)
    x = _x(rng, 3, 4000)
    _peak_close(tcm.apply_cfo(torch.as_tensor(x), 730.0, SRATE),
                jcm.apply_cfo(jnp.asarray(x), 730.0, SRATE), 1e-5)
    for d in (0, 1, 17):
        np.testing.assert_array_equal(tcm.apply_delay(torch.as_tensor(x), d).numpy(),
                                      np.asarray(jcm.apply_delay(jnp.asarray(x), d)))
    for prof in tcm.TDL_PROFILES:
        for scale in (1.0, 3.0):
            tc, jc = tcm.make_tdl(prof, SRATE, scale), jcm.make_tdl(prof, SRATE, scale)
            np.testing.assert_array_equal(tc.taps, jc.taps)
            np.testing.assert_allclose(tc.powers, jc.powers, rtol=1e-12)
            assert tc.max_delay == jc.max_delay
            h = _x(rng, len(tc.taps))
            _peak_close(tcm.apply_tdl(torch.as_tensor(x), tc, torch.as_tensor(h)),
                        jcm.apply_tdl(jnp.asarray(x), jc, jnp.asarray(h)))
    t = np.linspace(0.0, 25.0, 997).astype(np.float32)
    _peak_close(tcm.hst_doppler_hz(torch.as_tensor(t), 1340.0, 7.2),
                jcm.hst_doppler_hz(jnp.asarray(t), 1340.0, 7.2))
    _peak_close(tcm.apply_hst(torch.as_tensor(x), 1340.0, 0.01, SRATE),
                jcm.apply_hst(jnp.asarray(x), 1340.0, 0.01, SRATE), 1e-5)
    for on, off in ((2, 1), (1, 3)):
        np.testing.assert_array_equal(
            tcm.apply_rlf(torch.as_tensor(x), on, off, init_time_ms=0.5).numpy(),
            np.asarray(jcm.apply_rlf(jnp.asarray(x), on, off, init_time_ms=0.5)))


@pytest.mark.parametrize("snr_db", [0.0, 25.0])
def test_awgn_statistics(snr_db):
    """Noise power = signal power x 10^(-SNR/10) within 2 % (200,000
    samples), zero mean, equal real and imaginary power."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(_x(rng, 200_000) * 0.3)
    gen = torch.Generator().manual_seed(2)
    n = tcm.awgn(gen, x, snr_db) - x
    want = float((x.abs() ** 2).mean()) * 10 ** (-snr_db / 10)
    assert abs(float((n.abs() ** 2).mean()) / want - 1) < 0.02
    assert abs(float(n.real.pow(2).mean()) / float(n.imag.pow(2).mean()) - 1) < 0.03
    assert abs(complex(n.mean())) < 0.02 * np.sqrt(want)
    gen2 = torch.Generator().manual_seed(2)
    assert torch.equal(tcm.awgn(gen2, x, snr_db) - x, n)     # seeded


def test_tdl_tap_power_statistics():
    """Each tap h_i ~ CN(0, p_i): mean |h_i|^2 over 20,000 draws within 4 %
    of the profile's power; fade_awgn returns the faded, noisy samples."""
    ch = tcm.make_tdl("tdlc", 23.04e6)
    gen = torch.Generator().manual_seed(3)
    h = torch.stack([tcm.tdl_coefficients(gen, ch) for _ in range(20_000)])
    assert h.dtype == torch.complex64
    np.testing.assert_allclose((h.abs() ** 2).mean(0).numpy(), ch.powers, rtol=0.04)
    x = torch.as_tensor(_x(np.random.default_rng(4), 2, 3000))
    rx, taps = tcm.fade_awgn(torch.Generator().manual_seed(5), x, "tdla", 23.04e6, 30.0)
    assert rx.shape == x.shape and taps.shape == (len(tcm.make_tdl("tdla", 23.04e6).taps),)
    faded = tcm.apply_tdl(x, tcm.make_tdl("tdla", 23.04e6), taps)
    resid = float(((rx - faded).abs() ** 2).mean()) / float((faded.abs() ** 2).mean())
    assert 0.5e-3 < resid < 2e-3                                   # 30 dB
