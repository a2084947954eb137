"""Parity of the port's precoding, UL-SCH demultiplexing and UCI coding with
the JAX reference on the same numpy-seeded inputs: ops/precoding.py,
ops/ulsch_demux.py, ops/polar/rate_match.rate_dematch,
ops/polar/list_decoder.decode_scl and ops/uci.py.

  * Bit-level outputs are equal: demux positions and erasure masks,
    multiplexed streams, UCI codewords, decoded bits and CRC flags.
  * The transform precoder agrees to 2e-6 of the peak (both run a float32
    FFT, summed in another order); the precoding product to 2e-6 of the
    peak.  Dematched polar LLRs are equal (one addition per position, or a
    sum of repeated positions in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.ops import precoding as jpre
from srsran_edgeric_5g_tpu.ops import uci as juci
from srsran_edgeric_5g_tpu.ops import ulsch_demux as jdm
from srsran_edgeric_5g_tpu.ops.polar import list_decoder as jld
from srsran_edgeric_5g_tpu.ops.polar import rate_match as jprm
from srsran_edgeric_5g_tpu_torch.ops import precoding as tpre
from srsran_edgeric_5g_tpu_torch.ops import uci as tuci
from srsran_edgeric_5g_tpu_torch.ops import ulsch_demux as tdm
from srsran_edgeric_5g_tpu_torch.ops.polar import list_decoder as tld
from srsran_edgeric_5g_tpu_torch.ops.polar import rate_match as tprm

torch.set_num_threads(2)

DATA_SYMBOLS = (3, 4, 5, 6, 7, 8, 9, 10, 12, 13)   # tests/test_ulsch_demux.py


def _peak_close(got, want, tol=2e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def test_precoding_matches_reference():
    rng = np.random.default_rng(0)
    layers = _cplx(rng, 3, 2, 96)
    w = _cplx(rng, 4, 2)
    w_re = _cplx(rng, 3, 4, 2, 96)
    _peak_close(tpre.apply_precoding(torch.as_tensor(layers), w),
                jpre.apply_precoding(jnp.asarray(layers), jnp.asarray(w)))
    _peak_close(tpre.apply_precoding(torch.as_tensor(layers), torch.as_tensor(w_re)),
                jpre.apply_precoding(jnp.asarray(layers), jnp.asarray(w_re)))
    for nports, nlayers, scale in ((4, 2, None), (2, 4, None), (2, 2, 0.5)):
        np.testing.assert_array_equal(tpre.identity_precoding(nports, nlayers, scale),
                                      jpre.identity_precoding(nports, nlayers, scale))
    for m in range(1, 400):
        assert tpre.is_valid_dftsofdm_size(m) == jpre.is_valid_dftsofdm_size(m)
    for m in (48, 288, 300):
        x = _cplx(rng, 2, 10 * m)
        y = tpre.transform_precode(torch.as_tensor(x), m)
        _peak_close(y, jpre.transform_precode(jnp.asarray(x), m))
        _peak_close(tpre.transform_deprecode(y, m),
                    jpre.transform_deprecode(jnp.asarray(y.numpy()), m))
        _peak_close(tpre.transform_deprecode(y, m), x, 1e-5)     # round trip
    with pytest.raises(AssertionError):
        jpre.transform_precode(jnp.zeros((84,), jnp.complex64), 84)
    with pytest.raises(ValueError):
        tpre.transform_precode(torch.zeros((84,), dtype=torch.complex64), 84)
    with pytest.raises(ValueError):
        tpre.transform_deprecode(torch.zeros((84,), dtype=torch.complex64), 84)


# (qm, re_per_symbol, data_symbols, first DM-RS, UCI counts): the cases of
# tests/test_ulsch_demux.py, then CSI part 2 in both modes, then the UCI
# configurations of chip_smoke.py's pusch_uci phase on a 24-PRB 16QAM
# allocation.
DEMUX_CASES = [
    (2, 72, DATA_SYMBOLS, 2, dict(g_ack=16, g_csi1=24)),
    (2, 72, DATA_SYMBOLS, 2, dict(g_ack=8, g_csi1=16)),
    (2, 72, DATA_SYMBOLS, 2, dict(g_ack=8, g_ack_rvd=16, o_ack=2)),
    (4, 36, DATA_SYMBOLS, 2, dict(g_ack=16, g_csi1=32, g_csi2=48)),
    (2, 72, DATA_SYMBOLS, 2, dict(g_ack=8, g_ack_rvd=24, o_ack=2, g_csi1=16,
                                  g_csi2=40)),
    (4, 288, (3, 4, 5, 6, 7, 8, 9, 10, 12, 13), 2,
     dict(g_ack=64, g_csi1=160, g_csi2=96, o_ack=4)),
    (4, 288, (3, 4, 5, 6, 7, 8, 9, 10, 12, 13), 2,
     dict(g_ack=32, g_ack_rvd=64, o_ack=2, g_csi1=64)),
]


@pytest.mark.parametrize("case", range(len(DEMUX_CASES)))
def test_demux_plan_and_mux_match_reference(case):
    qm, m, syms, dmrs0, kw = DEMUX_CASES[case]
    g = qm * m * len(syms)
    jp = jdm.get_demux_plan(g, qm, m, syms, dmrs0, **kw)
    tp = tdm.get_demux_plan(g, qm, m, syms, dmrs0, **kw)
    for name in ("ack_positions", "csi1_positions", "csi2_positions",
                 "csi2_erased", "sch_positions", "sch_erased"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
    assert tp.sch_len == jp.sch_len and tp.key == jp.key

    rng = np.random.default_rng(case)
    sch = rng.integers(0, 2, (2, jp.sch_len), dtype=np.int8)
    uci = [rng.integers(0, 2, (2, len(p)), dtype=np.int8) if len(p) else None
           for p in (jp.ack_positions, jp.csi1_positions, jp.csi2_positions)]
    jm = jdm.multiplex(jnp.asarray(sch), jp,
                       *[None if u is None else jnp.asarray(u) for u in uci])
    tm = tdm.multiplex(torch.as_tensor(sch), tp,
                       *[None if u is None else torch.as_tensor(u) for u in uci])
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    llr = ((1 - 2 * np.asarray(jm).astype(np.float32))
           * rng.uniform(1, 20, size=jm.shape)).astype(np.float32)
    for got, want in zip(tdm.demultiplex(torch.as_tensor(llr), tp),
                         jdm.demultiplex(jnp.asarray(llr), jp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_demux_plan_rejects_what_the_reference_asserts():
    with pytest.raises(ValueError):          # the payload does not fit
        tdm.get_demux_plan(2 * 12 * 2, 2, 12, (3, 4), 2, g_ack=100)
    with pytest.raises(ValueError):          # G does not match the geometry
        tdm.get_demux_plan(100, 2, 12, (3, 4), 2, g_ack=8)


@pytest.mark.parametrize("k,e,mode", [(14, 96, "puncture"), (14, 40, "shorten"),
                                      (25, 600, "repeat"), (20, 160, "puncture")])
def test_polar_rate_dematch_matches_reference(k, e, mode):
    jc, _ = juci.uci_polar_code(k, e)
    tc, _ = tuci.uci_polar_code(k, e)
    assert jc.rm_mode == tc.rm_mode == mode
    llr = np.random.default_rng(e).normal(scale=4.0, size=(3, e)).astype(np.float32)
    got = tprm.rate_dematch(torch.as_tensor(llr), tc).numpy()
    want = np.asarray(jprm.rate_dematch(jnp.asarray(llr), jc))
    np.testing.assert_array_equal(got, want)


def _noisy(cw, snr_db, rng):
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2.0 * cw) + sigma * rng.normal(size=cw.shape)
    return (2 * y / sigma ** 2).astype(np.float32)


@pytest.mark.parametrize("k,e,snr_db", [(4, 64, -7.0), (14, 96, -6.0),
                                        (20, 160, -6.0)])
def test_uci_coding_and_decode_scl_match_reference(k, e, snr_db):
    """UCI encode and decode at K = 4 (short block), 14 (polar, CRC6 + PC)
    and 20 (polar, CRC11) on noisy LLRs where the list's paths compete (at
    these SNRs some codewords fail, most decode): equal codewords, bits and
    valid flags; for the polar codes decode_scl itself on the dematched LLRs,
    with CRC-aided selection and without a CRC (best metric, ok = True)."""
    rng = np.random.default_rng(100 + k)
    bits = rng.integers(0, 2, (24, k), dtype=np.int8)
    jcw = np.asarray(juci.encode(jnp.asarray(bits), e))
    tcw = tuci.encode(torch.as_tensor(bits), e).numpy()
    np.testing.assert_array_equal(tcw, jcw)
    llr = _noisy(jcw, snr_db, rng)
    jb, jok = juci.decode(jnp.asarray(llr), k, e)
    tb, tok = tuci.decode(torch.as_tensor(llr), k, e)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    right = (tb.numpy() == bits).all(axis=1).sum()
    assert len(bits) // 3 <= right < len(bits)
    if k < 12:
        return
    jc, crc = juci.uci_polar_code(k, e)
    tc, _ = tuci.uci_polar_code(k, e)
    mother = np.asarray(jprm.rate_dematch(jnp.asarray(llr), jc))
    jb, jok = jld.decode_scl(jnp.asarray(mother), jc, 8, crc)
    tb, tok = tld.decode_scl(torch.tensor(mother), tc, 8, crc)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0 < tok.sum() < len(bits)
    jb0, jok0 = jld.decode_scl(jnp.asarray(mother), jc, 8, None)
    tb0, tok0 = tld.decode_scl(torch.tensor(mother), tc, 8, None)
    np.testing.assert_array_equal(tb0.numpy(), np.asarray(jb0))
    assert tok0.all() and np.asarray(jok0).all()
