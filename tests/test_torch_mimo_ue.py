"""Parity of the port's per-UE multi-layer processor (models/mimo.py) with
the JAX reference, and of the decode it runs, decode(schedule="auto").

  * process_mimo grids equal to 2e-6 of the peak; receive_mimo at L = 2 and
    L = 4 through tests/test_mimo.py's mixing channels: payload, tb_ok and
    cb_ok equal; noise variance and SINR within rtol 1e-4, CFO within
    1e-2 Hz.
  * "auto" is the reference's "layered" off the TPU.  On the card it is the
    kernel's f32 mode with the l <= 0 hard rule and a per-codeblock exit,
    where "layered" exits once every codeword of the call meets parity.
    The plain twin with the card's rules is held to the reference's
    "layered" on receive_mimo's own decoder inputs at 20 MHz (chip_smoke.py's
    mimo_ue points), at SNRs where codeblocks need 3-6 sweeps and some never
    converge.  A study over 288 such codeblocks (L = 2 at 52 PRB, 14-17 and
    20-23 dB; L = 4 at 36 PRB, 16-19 and 23-26 dB; seeds 0-2; sweeps 1-6)
    found no codeblock whose bits or parity flag differ; three of its
    inputs are pinned here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.models import mimo as jmi
from srsran_edgeric_5g_tpu.models import pdsch as jpd
from srsran_edgeric_5g_tpu.models import pusch as jpu
from srsran_edgeric_5g_tpu.ops.ldpc import decoder as jdec
from srsran_edgeric_5g_tpu.ops.ldpc import segmenter as jseg
from srsran_edgeric_5g_tpu.ran import numerology as jnum
from srsran_edgeric_5g_tpu_torch.models import mimo as tmi
from srsran_edgeric_5g_tpu_torch.models import pdsch as tpd
from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder as tdec
from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder_cuda as tdc
from srsran_edgeric_5g_tpu_torch.ops.ldpc import encoder as tenc
from srsran_edgeric_5g_tpu_torch.ops.ldpc import segmenter as tseg
from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph

torch.set_num_threads(2)

T10 = jnum.slot_timing(**jnum.CELL_10MHZ)
T20 = jnum.slot_timing(**jnum.CELL_20MHZ)
# tests/test_mimo.py's channels: test_2x2_mixing_channel, test_4x4_mixing_channel.
H = {2: np.array([[1.0 + 0.2j, 0.45 - 0.3j],
                  [-0.35 + 0.4j, 0.9 - 0.1j]], dtype=np.complex64),
     4: (np.eye(4) + 0.3 * np.exp(1j * 0.7) * np.eye(4, k=1)
         + 0.25 * np.exp(-1j * 1.1) * np.eye(4, k=-1)
         + 0.15 * np.exp(1j * 2.0) * np.eye(4, k=2)).astype(np.complex64)}


def _cfgs(**kw):
    d = dict(rnti=0x31, nof_prb=24, start_prb=4, modulation="qam16",
             target_rate=0.4)
    d.update(kw)
    return jpd.PdschConfig(**d), tpd.PdschConfig(**d)


def _rx(grids, h, snr_db, rng):
    rx = np.einsum("ap,psk->ask", h, np.asarray(grids))
    sig = float(np.mean(np.abs(rx[np.abs(rx) > 0]) ** 2))
    noise = rng.normal(size=rx.shape) + 1j * rng.normal(size=rx.shape)
    return (rx + noise * np.sqrt(sig * 10 ** (-snr_db / 10) / 2)).astype(np.complex64)


def _ref_receive(rx, cfg, t, n_l):
    times = np.asarray(t.cp.data_starts) / t.srate

    def fields(x):
        r = jmi.receive_mimo(x, cfg, t.srate, times, n_layers=n_l)
        return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
    return jpu.PuschResult(**jax.jit(fields)(jnp.asarray(rx)))


@pytest.mark.parametrize("n_l,snr_db,kw", [
    (2, 27.0, {}), (4, 30.0, {}),
    (2, 27.0, dict(nof_prb=2, start_prb=40, modulation="qpsk", target_rate=0.2))])
def test_process_and_receive_mimo_match_reference(n_l, snr_db, kw):
    """L = 2 and 4 on a 24-PRB 16QAM UE, and a 2-PRB 2-layer QPSK UE whose
    TB lands at a lifting size under 64 (the "auto" decode's small-Zc
    case)."""
    jc, tc = _cfgs(**kw)
    t = T10
    times = np.asarray(t.cp.data_starts) / t.srate
    assert tmi.derived_tbs(tc, n_l) == jmi.derived_tbs(jc, n_l)
    seg, _ = tmi._plans(tc, 0, n_l)
    assert (seg.zc < 64) == bool(kw)
    rng = np.random.default_rng(n_l)
    pay = rng.integers(0, 2, (1, jmi.derived_tbs(jc, n_l)), dtype=np.int8)
    grids = jax.jit(lambda x: jmi.process_mimo(x, jc, t.nsymb, t.nof_subc,
                                               n_layers=n_l))(jnp.asarray(pay))
    got_g = tmi.process_mimo(torch.as_tensor(pay), tc, t.nsymb, t.nof_subc,
                             n_layers=n_l).numpy()
    assert np.abs(got_g - np.asarray(grids)).max() <= 2e-6 * np.abs(grids).max()
    rx = _rx(grids, H[n_l], snr_db, rng)
    want = _ref_receive(rx, jc, t, n_l)
    got = tmi.receive_mimo(torch.as_tensor(rx), tc, t.srate, times, n_layers=n_l)
    for f in ("payload", "tb_crc_ok", "cb_crc_ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(got.payload.numpy(), pay)
    assert got.tb_crc_ok.all() and got.soft_buffer is None
    for f in ("noise_var", "evm_sinr_db"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-4)
    np.testing.assert_allclose(got.cfo_hz.numpy(), np.asarray(want.cfo_hz), atol=1e-2)
    if n_l == 2 and not kw:
        got2 = tmi.receive_2layer(torch.as_tensor(rx), tc, t.srate, times)
        assert torch.equal(got2.payload, got.payload)
        assert torch.equal(tmi.process_2layer(torch.as_tensor(pay), tc, t.nsymb,
                                              t.nof_subc), torch.as_tensor(got_g))
    x = torch.as_tensor(np.arange(12, dtype=np.float32).reshape(1, 12))
    assert torch.equal(tmi.layer_demap(tmi.layer_map(x, n_l)), x)
    np.testing.assert_array_equal(tmi.layer_map(x, n_l).numpy(),
                                  np.asarray(jmi.layer_map(jnp.asarray(x.numpy()), n_l)))


# (L, PRBs, first PRB, SNR dB, seed): 20 MHz, 64QAM r0.5, where the study
# found mixed sweep counts (and at 16 dB a codeblock that never converges).
STUDY_INPUTS = [(2, 52, 0, 16.0, 0), (4, 36, 52, 17.0, 2), (4, 36, 52, 16.0, 2)]


@pytest.mark.parametrize("case", range(len(STUDY_INPUTS)))
def test_auto_equals_reference_layered_early_stop_granularity(case):
    n_l, nprb, start, snr_db, seed = STUDY_INPUTS[case]
    _, tc = _cfgs(rnti=0x4605, nof_prb=nprb, start_prb=start, modulation="qam64",
                  target_rate=0.5)
    t = T20
    times = np.asarray(t.cp.data_starts) / t.srate
    seg, _ = tmi._plans(tc, 0, n_l)
    rng = np.random.default_rng(seed)
    pay = torch.as_tensor(rng.integers(0, 2, (1, tmi.derived_tbs(tc, n_l)),
                                       dtype=np.int8))
    grids = tmi.process_mimo(pay, tc, t.nsymb, t.nof_subc, n_layers=n_l)
    rx = _rx(grids.numpy(), H[n_l], snr_db, rng)
    full, _, _ = tmi.decoder_input(torch.as_tensor(rx), tc, times, n_layers=n_l)
    hj, okj = jax.jit(lambda x: jdec.decode(x, seg.bg, seg.zc, num_iters=6,
                                            schedule="layered", early_stop=True))(
        jnp.asarray(full.numpy()))
    ha, oka = tdec.decode(full, seg.bg, seg.zc, num_iters=6, schedule="auto")
    np.testing.assert_array_equal(ha.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(oka.numpy(), np.asarray(okj))
    # The card's rules: per-codeblock exit, l <= 0.
    hp, okp, sweeps = tdc.decode_layered_plain(full, seg.bg, seg.zc, 6, wire=False,
                                               early_stop=True, strict=False)
    np.testing.assert_array_equal(hp.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    assert len(set(sweeps.tolist())) >= 2          # the two exits could differ
    pj, tbj = jseg.desegment_tb(hj, jseg.get_segment_plan(
        seg.a, seg.bg, n_l * tc.g_total, tc.qm))
    pt, tbt = tseg.desegment_tb(hp, seg)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(tbt.numpy(), np.asarray(tbj))


@pytest.mark.parametrize("bg,zc", [(2, 40), (2, 15), (1, 26)])
def test_auto_at_small_lifting_sizes(bg, zc):
    """"auto" takes every lifting size (the reference's "layered" does):
    equal to it at Zc < 64, where decode_pallas' floor would refuse."""
    g = get_graph(bg, zc)
    rng = np.random.default_rng(zc)
    msgs = rng.integers(0, 2, (6, g.k), dtype=np.int8)
    cw = tenc.encode(torch.as_tensor(msgs), bg, zc).numpy()
    sigma = 10 ** (-1.0 / 20)
    y = (1 - 2.0 * cw[:, 2 * zc:]) + sigma * rng.normal(size=cw[:, 2 * zc:].shape)
    llr = np.concatenate([np.zeros((6, 2 * zc)), 2 * y / sigma ** 2], 1).astype(np.float32)
    hj, okj = jdec.decode(jnp.asarray(llr), bg, zc, schedule="layered")
    ht, okt = tdec.decode(torch.as_tensor(llr), bg, zc, schedule="auto")
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    hp, okp, _ = tdc.decode_layered_plain(torch.as_tensor(llr), bg, zc, wire=False,
                                          early_stop=True, strict=False)
    np.testing.assert_array_equal(hp.numpy(), np.asarray(hj))
    assert tdc.cuda_supported(zc, tdc.MODE_F32, strict=False)
    assert not tdc.cuda_supported(zc, tdc.MODE_F32)


def test_hard_rule_on_an_exact_zero_posterior():
    """The two f32 rules differ only on an exact-zero posterior: an all-erased
    codeblock decodes to all ones under "layered"'s l <= 0 (so "auto" and
    the reference agree, and the TB CRC fails) and to the all-zero word
    under decode_pallas' post < 0 (which desegment_tb's all-zero guard
    rejects)."""
    bg, zc = 2, 40
    g = get_graph(bg, zc)
    zeros = np.zeros((2, g.n_full), np.float32)
    hj, okj = jdec.decode(jnp.asarray(zeros), bg, zc, schedule="layered")
    ht, okt = tdec.decode(torch.as_tensor(zeros), bg, zc, schedule="auto")
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert (ht == 1).all()
    hs, oks, _ = tdc.decode_layered_plain(torch.as_tensor(zeros), bg, zc, wire=False,
                                          early_stop=True)
    assert (hs == 0).all() and oks.all()
    seg = tseg.get_segment_plan(288, bg, 1000, 2)
    assert seg.zc == zc
    _, ok_le = tseg.desegment_tb(ht[:1], seg)
    _, ok_lt = tseg.desegment_tb(hs[:1], seg)
    assert not ok_le.any() and not ok_lt.any()
    with pytest.raises(ValueError):
        tdc.decode_layered_plain(torch.zeros((1, g.n_full), dtype=torch.int8), bg, zc,
                                 wire=True, strict=True)
