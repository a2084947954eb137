"""Parity of the port's per-UE PDSCH / PUSCH processors with the JAX
reference on the same numpy-seeded inputs (models/pdsch.py, models/pusch.py,
ops/evm.py), on the 10 MHz cell.

  * Bit-level outputs are equal: coded and scrambled bits, payloads,
    tb_crc_ok, cb_crc_ok, ACK / CSI bits.
  * Grids agree to 2e-6 of the peak; noise variance and SINR to rtol 1e-4;
    CFO within 1e-2 Hz.
  * The float32 HARQ buffers hold dematched wire LLRs, integers from float32
    fronts that sum in other orders: a ±1 step is allowed in at most 1e-3 of
    the entries.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.models import pdsch as jpd
from srsran_edgeric_5g_tpu.models import pusch as jpu
from srsran_edgeric_5g_tpu.ops import dmrs as jdmrs
from srsran_edgeric_5g_tpu.ops import evm as jevm
from srsran_edgeric_5g_tpu.ran import numerology as jnum
from srsran_edgeric_5g_tpu_torch.models import pdsch as tpd
from srsran_edgeric_5g_tpu_torch.models import pusch as tpu
from srsran_edgeric_5g_tpu_torch.ops import dmrs as tdmrs
from srsran_edgeric_5g_tpu_torch.ops import evm as tevm

torch.set_num_threads(2)

T = jnum.slot_timing(**jnum.CELL_10MHZ)
TIMES = np.asarray(T.cp.data_starts) / T.srate
RTOL = 1e-4

# Grants on the 10 MHz cell: each exercises a branch of the per-UE path.
GRANTS = {
    "qam16": dict(rnti=0x4602, start_prb=4, nof_prb=24, modulation="qam16",
                  target_rate=0.479),
    "qam64_2cb": dict(rnti=0x4603, start_prb=28, nof_prb=24, modulation="qam64",
                      target_rate=0.75),
    # One DM-RS symbol: no CFO estimate, and an unequal E split.
    "one_dmrs": dict(rnti=0x4604, start_prb=6, nof_prb=46, modulation="qam64",
                     target_rate=0.926, dmrs_symbols=(2,)),
    "dftsofdm": dict(rnti=0x4601, start_prb=0, nof_prb=4, modulation="qpsk",
                     target_rate=0.188, transform_precoding=True),
    "lbrm": dict(rnti=0x4605, start_prb=10, nof_prb=30, modulation="qam64",
                 target_rate=0.6, tbs_lbrm=20000),
}


def _cfgs(name, **kw):
    d = {**GRANTS[name], **kw}
    return jpd.PdschConfig(**d), tpd.PdschConfig(**d)


def _peak_close(got, want, tol=2e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _wire_close(got, want):
    """Integer-valued LLR buffers: equal but for ±1 steps in <= 1e-3."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def _ref(fn, *args):
    """The reference's PuschResult of ``fn(*args)`` under one jit (one
    compilation instead of its op-by-op dispatch)."""
    def fields(*a):
        r = fn(*a)
        return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
    return jpu.PuschResult(**jax.jit(fields)(*args))


def _payload(cfg, rng):
    return rng.integers(0, 2, (1, cfg.derived_tbs()), dtype=np.int8)


def _noisy_grid(grid, snr_db, rng):
    nv = 10 ** (-snr_db / 10)
    noise = rng.normal(size=grid.shape) + 1j * rng.normal(size=grid.shape)
    return (np.asarray(grid) + noise * np.sqrt(nv / 2)).astype(np.complex64)


def test_unequal_e_and_lbrm_grants():
    """The grants really take the branches they are named for."""
    seg, rms = tpd._plans(_cfgs("one_dmrs")[1])
    assert len(set(seg.e)) == 2 and len(rms) == 2
    _, rms = tpd._plans(_cfgs("lbrm")[1])
    assert rms[0].n_cb < (rms[0].zc * (66 if rms[0].bg == 1 else 50))
    assert tpd._plans(_cfgs("dftsofdm")[1])[0].zc < 64


@pytest.mark.parametrize("name,rv,scramble,e_cut", [
    ("qam16", 0, True, 0), ("qam64_2cb", 2, True, 0), ("one_dmrs", 0, True, 0),
    ("one_dmrs", 3, False, 0), ("lbrm", 0, True, 0), ("lbrm", 1, True, 0),
    ("qam16", 0, False, 192), ("dftsofdm", 2, True, 0)])
def test_encode_transport_block_matches_reference(name, rv, scramble, e_cut):
    jc, tc = _cfgs(name)
    pay = _payload(jc, np.random.default_rng(rv + e_cut))
    e_total = jc.g_total - e_cut if e_cut else None
    want = jax.jit(lambda x: jpd.encode_transport_block(x, jc, rv, scramble, e_total))(
        jnp.asarray(pay))
    got = tpd.encode_transport_block(torch.as_tensor(pay), tc, rv, scramble, e_total)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tpd.scrambling_c_init(0x4601, 7, 1) == jpd.scrambling_c_init(0x4601, 7, 1)


@pytest.mark.parametrize("name", ["qam16", "dftsofdm", "one_dmrs"])
def test_pilots_grid_and_process_match_reference(name):
    jc, tc = _cfgs(name, slot=3, n_id=17)
    pat_j = jdmrs.dmrs_pattern(1, jc.nof_prb, port=0)
    pat_t = tdmrs.dmrs_pattern(1, tc.nof_prb, port=0)
    for l in jc.dmrs_symbols:
        _peak_close(tpd.pilot_values(tc, l, pat_t),
                    jpd.pilot_values(jc, l, pat_j))
    rng = np.random.default_rng(1)
    syms = (rng.normal(size=(1, jc.nof_data_re))
            + 1j * rng.normal(size=(1, jc.nof_data_re))).astype(np.complex64)
    _peak_close(tpd.map_to_grid(torch.as_tensor(syms), tc, T.nsymb, T.nof_subc,
                                amplitude=0.7, dmrs_scale=1.3),
                jpd.map_to_grid(jnp.asarray(syms), jc, T.nsymb, T.nof_subc,
                                amplitude=0.7, dmrs_scale=1.3))
    pay = _payload(jc, rng)
    _peak_close(tpd.process(torch.as_tensor(pay), tc, T.nsymb, T.nof_subc, rv=1),
                jax.jit(lambda x: jpd.process(x, jc, T.nsymb, T.nof_subc, rv=1))(
                    jnp.asarray(pay)))


UCI_SHORT = {
    # Skip mode (O_ack > 2): the SCH rate-matches around the UCI REs.
    "skip": dict(n_ack=4, g_ack=64, n_csi1=8, g_csi1=64),
    # Reserved mode (O_ack <= 2): the ACK punctures the SCH.
    "reserved": dict(n_ack=2, g_ack=32, g_ack_rvd=64, n_csi1=8, g_csi1=64),
    # Polar CSI (CRC11 and CRC6 + PC): tests/test_torch_precoding_uci.py
    # holds decode_scl on these codes; the grid here.
    "polar": dict(n_ack=4, g_ack=64, n_csi1=20, g_csi1=160, n_csi2=14, g_csi2=96),
}


def _uci_bits(u, rng):
    return {k: rng.integers(0, 2, (1, n), dtype=np.int8) if n else None
            for k, n in (("ack_bits", u.n_ack), ("csi1_bits", u.n_csi1),
                         ("csi2_bits", u.n_csi2))}


@pytest.mark.parametrize("name,uci", [("qam16", None), ("qam16", "skip"),
                                      ("qam16", "reserved"), ("qam16", "polar"),
                                      ("dftsofdm", None)])
def test_pusch_transmit_matches_reference(name, uci):
    jc, tc = _cfgs(name)
    rng = np.random.default_rng(2)
    pay = _payload(jc, rng)
    ju = tu = None
    kw = {}
    if uci:
        ju, tu = jpu.UciConfig(**UCI_SHORT[uci]), tpu.UciConfig(**UCI_SHORT[uci])
        kw = _uci_bits(ju, rng)
    want = jax.jit(lambda x, b: jpu.transmit(x, jc, T.nsymb, T.nof_subc, rv=2,
                                             uci=ju, **b))(
        jnp.asarray(pay), {k: None if v is None else jnp.asarray(v)
                           for k, v in kw.items()})
    got = tpu.transmit(torch.as_tensor(pay), tc, T.nsymb, T.nof_subc, rv=2, uci=tu,
                       **{k: None if v is None else torch.as_tensor(v)
                          for k, v in kw.items()})
    _peak_close(got, want)


def _same_result(got, want, uci=None):
    for f in ("payload", "tb_crc_ok", "cb_crc_ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.tb_crc_ok.all()
    np.testing.assert_allclose(got.noise_var.numpy(), np.asarray(want.noise_var),
                               rtol=RTOL)
    np.testing.assert_allclose(got.evm_sinr_db.numpy(),
                               np.asarray(want.evm_sinr_db), rtol=RTOL)
    np.testing.assert_allclose(got.cfo_hz.numpy(), np.asarray(want.cfo_hz),
                               atol=1e-2)
    _wire_close(got.soft_buffer.numpy(), want.soft_buffer)
    for f in ("ack_bits", "csi1_bits", "csi2_bits"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name,kw,uci", [
    ("qam16", dict(delay_spread_s=None), None),
    ("qam64_2cb", dict(delay_spread_s=1e-6), None),
    ("one_dmrs", dict(delay_spread_s=None), None),
    ("dftsofdm", dict(delay_spread_s=None), None),
    ("qam16", dict(delay_spread_s=None), "skip"),
    ("qam16", dict(delay_spread_s=None), "reserved"),
    ("lbrm", dict(delay_spread_s=None), None),
    ("one_dmrs", dict(delay_spread_s=None, dc=True), None),
])
def test_pusch_process_matches_reference(name, kw, uci):
    """One received grid through both receivers: LS or TA + smoothing
    estimate, one DM-RS symbol (no CFO ramp, unequal E), DFT-s-OFDM, UCI in
    both modes, the DC position inside the band, LBRM."""
    kw = dict(kw)
    dc = kw.pop("dc", False)
    extra = {}
    if dc:
        extra["dc_position"] = GRANTS[name]["start_prb"] * 12 + 101
    jc, tc = _cfgs(name, **extra)
    rng = np.random.default_rng(3)
    pay = _payload(jc, rng)
    ju = tu = None
    bits = {}
    if uci:
        ju, tu = jpu.UciConfig(**UCI_SHORT[uci]), tpu.UciConfig(**UCI_SHORT[uci])
        bits = _uci_bits(ju, rng)
    grid = jax.jit(lambda x, b: jpu.transmit(x, jc, T.nsymb, T.nof_subc, uci=ju,
                                             **b))(
        jnp.asarray(pay), {k: None if v is None else jnp.asarray(v)
                           for k, v in bits.items()})
    rx = _noisy_grid(grid, 25.0, rng)
    want = _ref(lambda x: jpu.process(x, jc, T.srate, TIMES, uci=ju, **kw),
                jnp.asarray(rx))
    got = tpu.process(torch.as_tensor(rx), tc, T.srate, TIMES, uci=tu, **kw)
    _same_result(got, want)
    np.testing.assert_array_equal(got.payload.numpy(), pay)
    for k, v in bits.items():
        if v is not None:
            np.testing.assert_array_equal(getattr(got, k).numpy(), v)


def test_pusch_harq_combine_matches_reference():
    """rv 0 then rv 2 at 12 dB on the grid (64QAM r0.75): each fails alone,
    the combination through the reference's float32 soft buffer decodes,
    in both packages alike."""
    jc, tc = _cfgs("qam64_2cb")
    rng = np.random.default_rng(4)
    pay = _payload(jc, rng)
    rx = [_noisy_grid(tpu.transmit(torch.as_tensor(pay), tc, T.nsymb, T.nof_subc,
                                   rv=rv), 12.0, rng) for rv in (0, 2)]
    want0 = _ref(lambda x: jpu.process(x, jc, T.srate, TIMES, rv=0),
                 jnp.asarray(rx[0]))
    got0 = tpu.process(torch.as_tensor(rx[0]), tc, T.srate, TIMES, rv=0)
    np.testing.assert_array_equal(got0.tb_crc_ok.numpy(), np.asarray(want0.tb_crc_ok))
    assert not got0.tb_crc_ok.any()
    _wire_close(got0.soft_buffer.numpy(), want0.soft_buffer)
    soft = np.asarray(want0.soft_buffer)
    want = _ref(lambda x, sb: jpu.process(x, jc, T.srate, TIMES, rv=2,
                                          soft_buffer=sb),
                jnp.asarray(rx[1]), jnp.asarray(soft))
    got = tpu.process(torch.as_tensor(rx[1]), tc, T.srate, TIMES, rv=2,
                      soft_buffer=torch.as_tensor(soft))
    _same_result(got, want)
    np.testing.assert_array_equal(got.payload.numpy(), pay)
    fresh = tpu.process(torch.as_tensor(rx[1]), tc, T.srate, TIMES, rv=2)
    assert not fresh.tb_crc_ok.any()


def test_pdsch_receive_matches_reference():
    """The UE-side PDSCH receiver (0 dB DM-RS, no UCI) on a DL grid."""
    jc, tc = _cfgs("qam64_2cb")
    rng = np.random.default_rng(5)
    pay = _payload(jc, rng)
    rx = _noisy_grid(tpd.process(torch.as_tensor(pay), tc, T.nsymb, T.nof_subc),
                     25.0, rng)
    want = _ref(lambda x: jpd.receive(x, jc, T.srate, TIMES), jnp.asarray(rx))
    got = tpd.receive(torch.as_tensor(rx), tc, T.srate, TIMES)
    _same_result(got, want)
    np.testing.assert_array_equal(got.payload.numpy(), pay)


@pytest.mark.parametrize("mod", ["qpsk", "qam16", "qam64"])
def test_evm_matches_reference(mod):
    rng = np.random.default_rng(6)
    qm = {"qpsk": 2, "qam16": 4, "qam64": 6}[mod]
    y = (rng.normal(size=(3, 200)) + 1j * rng.normal(size=(3, 200))).astype(np.complex64)
    llr = rng.normal(scale=5.0, size=(3, 200 * qm)).astype(np.float32)
    llr[0, :7] = 0.0                                   # ties decide 0
    e_t = tevm.evm(torch.as_tensor(y), torch.as_tensor(llr), mod)
    e_j = jevm.evm(jnp.asarray(y), jnp.asarray(llr), mod)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-5)
    np.testing.assert_allclose(tevm.sinr_from_evm(e_t).numpy(),
                               np.asarray(jevm.sinr_from_evm(e_j)), rtol=1e-5)
    assert float(tevm.sinr_from_evm(torch.zeros(()))) == pytest.approx(180.0)


def test_pdsch_config_is_the_references():
    """Same fields, defaults and derived sizes, so grant layouts carry over
    (convert.pdsch_config_from_dict)."""
    assert [f.name for f in dataclasses.fields(tpd.PdschConfig)] == \
        [f.name for f in dataclasses.fields(jpd.PdschConfig)]
    assert [f.name for f in dataclasses.fields(tpu.UciConfig)] == \
        [f.name for f in dataclasses.fields(jpu.UciConfig)]
    for name in GRANTS:
        jc, tc = _cfgs(name)
        assert (tc.data_symbols, tc.qm, tc.g_total, tc.derived_tbs()) == \
            (jc.data_symbols, jc.qm, jc.g_total, jc.derived_tbs())
    assert tpu.PUSCH_DMRS_BETA == jpu.PUSCH_DMRS_BETA
