"""Parity of the port's single-shot control-channel functions with the JAX
reference: PUCCH formats 0/1/2 (generate and detect / decode), PRACH
(generate, the occasion modulator, every format's layout, unrestricted and
restricted set A tables, detection), SRS and CSI-RS mapping and snapshots,
PDCCH (DCI encode, single and multi-DCI CORESETs, blind decode), the SSB
(PBCH encode, the block, the PBCH receive), the polar SC decoder, DM-RS
mapping, low-PAPR sequences, PSS/SSS mapping and the PSS correlator.

Inputs are made from numpy seeds and go through both packages; the JAX side
is jitted where its own tests would otherwise dispatch op by op.  Bits,
``ok`` flags, detections and delays are compared exactly; grids, sequences
and metrics within the tolerance stated at each assert (float32 stages in
two libraries).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.models import pdcch as jpdcch, ssb as jssb
from srsran_edgeric_5g_tpu.ops import csi_rs as jcsi, dmrs as jdmrs
from srsran_edgeric_5g_tpu.ops import low_papr as jlp, prach as jprach
from srsran_edgeric_5g_tpu.ops import pucch as jpucch, sync_signals as jsync
from srsran_edgeric_5g_tpu.ops.polar import code as jcode, decoder as jdec
from srsran_edgeric_5g_tpu.ops.polar import encoder as jenc, rate_match as jrm
from srsran_edgeric_5g_tpu_torch.models import pdcch as tpdcch, ssb as tssb
from srsran_edgeric_5g_tpu_torch.ops import csi_rs as tcsi, dmrs as tdmrs
from srsran_edgeric_5g_tpu_torch.ops import low_papr as tlp, prach as tprach
from srsran_edgeric_5g_tpu_torch.ops import pucch as tpucch, sync_signals as tsync
from srsran_edgeric_5g_tpu_torch.ops.polar import code as tcode, decoder as tdec

# Six test workers share the host with the JAX tests: two intra-op threads.
torch.set_num_threads(2)

NSUBC = 624          # 52 PRB
SRATE = 11_520_000   # the 10 MHz cell
# Grids, sequences and symbols built from the same constants in float32.
GRID_ATOL = 1e-6


def np_(x):
    return np.array(x)


def cnoise(rng, shape, sigma):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape)) * sigma
            ).astype(np.complex64)


# ------------------------------------------------------------------ PUCCH

def test_pucch_format0_detect():
    """Sequences to GRID_ATOL; on a noisy occasion the same best m0 and the
    metrics within 1e-5 relative."""
    kw = dict(n_id=11, slot=3, start_symbol=12, nof_symbols=2, initial_cs=2)
    cj, ct = jpucch.Pucch01Config(**kw), tpucch.Pucch01Config(**kw)
    rng = np.random.default_rng(0)
    cands = (0, 3, 6, 9)
    for m0 in cands:
        seq = np_(jpucch.format0_generate(cj, m0))
        np.testing.assert_allclose(tpucch.format0_generate(ct, m0, device="cpu").numpy(),
                                   seq, rtol=0, atol=GRID_ATOL)
        rx = seq * np.complex64(0.7 * np.exp(0.3j)) + cnoise(rng, seq.shape, 0.3)
        mj, bj = jpucch.format0_detect(jnp.asarray(rx), cj, cands)
        mt, bt = tpucch.format0_detect(torch.as_tensor(rx), ct, cands)
        assert int(bt) == int(bj) == cands.index(m0)
        np.testing.assert_allclose(mt.numpy(), np_(mj), rtol=1e-5)


@pytest.mark.parametrize("nbits", [1, 2])
def test_pucch_format1_detect(nbits):
    """Data and DM-RS rows and the occasion grid to GRID_ATOL; the same bits
    and the metric within 1e-5 relative on a noisy occasion."""
    kw = dict(n_id=5, slot=1, start_symbol=3, nof_symbols=10, initial_cs=4, prb=3)
    cj, ct = jpucch.Pucch01Config(**kw), tpucch.Pucch01Config(**kw)
    rng = np.random.default_rng(nbits)
    for occ in (0, 2):
        bits = rng.integers(0, 2, nbits)
        for fj, ft in ((lambda: jpucch.format1_generate(cj, bits, occ),
                        lambda: tpucch.format1_generate(ct, bits, occ, device="cpu")),
                       (lambda: jpucch.format1_dmrs(cj, occ),
                        lambda: tpucch.format1_dmrs(ct, occ, device="cpu"))):
            np.testing.assert_allclose(ft().numpy(), np_(fj()), rtol=0, atol=GRID_ATOL)
        grid = np_(jpucch.format1_process(bits, cj, 14, NSUBC, occ_index=occ))
        np.testing.assert_allclose(
            tpucch.format1_process(bits, ct, 14, NSUBC, occ_index=occ,
                                   device="cpu").numpy(), grid, rtol=0, atol=GRID_ATOL)
        rx = grid[4:13:2, 36:48] + cnoise(rng, (5, 12), 0.2)
        bj, mj = jpucch.format1_detect(jnp.asarray(rx), cj, nbits, occ)
        bt, mt = tpucch.format1_detect(torch.as_tensor(rx), ct, nbits, occ)
        np.testing.assert_array_equal(bt.numpy(), np_(bj))
        np.testing.assert_array_equal(bt.numpy(), bits.astype(np.int8))
        np.testing.assert_allclose(float(mt), float(mj), rtol=1e-5)


@pytest.mark.parametrize("k", [3, 11, 14])
def test_pucch_format2_decode(k):
    """Short block (K <= 11) and polar UCI (CRC6 + PC): the grid to
    GRID_ATOL; through a flat channel and in-allocation noise the same bits
    and ok flags as the reference."""
    kw = dict(rnti=0x4601, n_id=31, n_id0=7, slot=0, start_symbol=12,
              nof_symbols=2, start_prb=5, nof_prb=6 if k > 11 else 4, uci_bits=k)
    cj, ct = jpucch.Pucch2Config(**kw), tpucch.Pucch2Config(**kw)
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (1, k), dtype=np.int8)
    grid = np_(jax.jit(lambda b: jpucch.format2_process(b, cj, 14, NSUBC))(
        jnp.asarray(bits)))
    np.testing.assert_allclose(tpucch.format2_process(torch.as_tensor(bits), ct, 14,
                                                      NSUBC).numpy(),
                               grid, rtol=0, atol=GRID_ATOL)
    np.testing.assert_array_equal(
        tpucch.format2_uci_encode(torch.as_tensor(bits), ct).numpy(),
        np_(jax.jit(lambda b: jpucch.format2_uci_encode(b, cj))(jnp.asarray(bits))))
    rx = (grid * np.complex64(0.9 * np.exp(0.4j))
          + cnoise(rng, grid.shape, 0.05) * (np.abs(grid) > 0))
    oj, okj = jax.jit(lambda g: jpucch.format2_decode(g, cj))(jnp.asarray(rx))
    ot, okt = tpucch.format2_decode(torch.as_tensor(rx), ct)
    np.testing.assert_array_equal(ot.numpy(), np_(oj))
    np.testing.assert_array_equal(okt.numpy(), np_(okj))
    np.testing.assert_array_equal(ot.numpy(), bits)


# ------------------------------------------------------------------ PRACH

PRACH_CASES = {
    # long format 0 at the 10 MHz cell, unrestricted
    "long": (dict(root_sequence_index=1, zero_correlation_zone=13), "0", (23, 50)),
    # short format A1 (L = 139, two repetitions)
    "short": (dict(root_sequence_index=1,
                   zero_correlation_zone=jprach.ncs_from_zcz_short(11),
                   l_ra=jprach.L_SHORT), "A1", (0, 17)),
    # restricted set A (Doppler-robust shift groups over several roots)
    "restricted": (dict(root_sequence_index=1, zero_correlation_zone=15,
                        restricted="a"), "0", (9, 37)),
}


@pytest.mark.parametrize("case", list(PRACH_CASES))
def test_prach_generate_modulate_detect(case):
    """The 64-preamble table equal; the frequency preamble and the occasion
    to 1e-5 of unit amplitude; on a noisy, delayed occasion equal detected
    flags and delays everywhere, metrics within 1e-4 relative."""
    kw, fmt, indices = PRACH_CASES[case]
    cj, ct = jprach.PrachConfig(**kw), tprach.PrachConfig(**kw)
    assert ct.preamble_table == cj.preamble_table
    info_j = jprach.prach_format_info(fmt, SRATE)
    info_t = tprach.prach_format_info(fmt, SRATE)
    assert dataclasses.asdict(info_t) == dataclasses.asdict(info_j)
    rng = np.random.default_rng(len(case))
    for idx in indices:
        pre = np_(jax.jit(lambda: jprach.generate(cj, idx))())
        np.testing.assert_allclose(tprach.generate(ct, idx, device="cpu").numpy(),
                                   pre, rtol=0, atol=1e-5 * np.abs(pre).max())
        td = np_(jax.jit(lambda p: jprach.ofdm_modulate_prach(p, info_j))(jnp.asarray(pre)))
        np.testing.assert_allclose(
            tprach.ofdm_modulate_prach(torch.as_tensor(pre), info_t).numpy(),
            td, rtol=0, atol=1e-5)
        rx = np.roll(td, 3) + cnoise(rng, td.shape, 0.3)
        mj, delj, detj = jax.jit(lambda x: dataclasses.astuple(jprach.detect(
            jprach.ofdm_demodulate_prach(x, info_j), cj)))(jnp.asarray(rx))
        dt = tprach.detect(tprach.ofdm_demodulate_prach(torch.as_tensor(rx), info_t), ct)
        np.testing.assert_array_equal(dt.detected.numpy(), np_(detj))
        np.testing.assert_array_equal(dt.delays.numpy(), np_(delj))
        np.testing.assert_allclose(dt.metrics.numpy(), np_(mj), rtol=1e-4)
        # A fractional delay may also lift the neighbouring zone's edge.
        assert dt.detected.numpy()[idx]


def test_prach_tables():
    """N_cs tables, restricted shift sets of the first 300 roots, and the
    short-preamble N_cs, as the reference."""
    for z in range(16):
        assert tprach.ncs_from_zcz_short(z) == jprach.ncs_from_zcz_short(z)
    for idx in range(300):
        u = jprach.sequence_number(idx)
        for n_cs in (15, 46, 100):
            assert (tprach.restricted_cyclic_shifts(u, n_cs)
                    == jprach.restricted_cyclic_shifts(u, n_cs))
    for fmt in jprach.PRACH_FORMATS:
        assert tprach.PRACH_FORMATS[fmt] == jprach.PRACH_FORMATS[fmt]
        for mu in (0, 1):
            if fmt[0] in "ABC" or mu == 0:
                assert (dataclasses.asdict(tprach.prach_format_info(fmt, 30_720_000, mu))
                        == dataclasses.asdict(jprach.prach_format_info(fmt, 30_720_000, mu)))


# ------------------------------------------------------------ SRS, CSI-RS

def test_srs_and_csi_rs_estimate():
    """Mapped grids to GRID_ATOL; on a noisy channel the LS snapshots within
    1e-5 absolute and the SRS SNR within 1e-4 relative."""
    rng = np.random.default_rng(7)
    for comb, cs in ((2, 3), (4, 5)):
        kw = dict(sequence_id=9, slot=2, symbol=13, start_prb=4, nof_prb=16,
                  comb=comb, comb_offset=1, cyclic_shift=cs)
        sj, st = jcsi.SrsConfig(**kw), tcsi.SrsConfig(**kw)
        g0 = np.zeros((14, NSUBC), np.complex64)
        gj = np_(jax.jit(lambda g: jcsi.map_srs(g, sj, amplitude=0.7))(jnp.asarray(g0)))
        gt = tcsi.map_srs(torch.as_tensor(g0), st, amplitude=0.7)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=GRID_ATOL)
        rx = gj * np.complex64(np.exp(0.8j)) + cnoise(rng, gj.shape, 0.05)
        hj, snr_j = jax.jit(lambda x: jcsi.srs_estimate(x, sj))(jnp.asarray(rx))
        ht, snr_t = tcsi.srs_estimate(torch.as_tensor(rx), st)
        np.testing.assert_allclose(ht.numpy(), np_(hj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(snr_t), float(snr_j), rtol=1e-4)
    for density in (1, 3):
        kw = dict(scrambling_id=13, slot=4, symbol=5, start_prb=2, nof_prb=20,
                  density=density, comb_offset=2)
        cj, ct = jcsi.CsiRsConfig(**kw), tcsi.CsiRsConfig(**kw)
        g0 = np.zeros((14, NSUBC), np.complex64)
        gj = np_(jax.jit(lambda g: jcsi.map_csi_rs(g, cj))(jnp.asarray(g0)))
        np.testing.assert_allclose(tcsi.map_csi_rs(torch.as_tensor(g0), ct).numpy(),
                                   gj, rtol=0, atol=GRID_ATOL)
        rx = gj * np.complex64(0.5 - 0.2j) + cnoise(rng, gj.shape, 0.05)
        np.testing.assert_allclose(
            tcsi.csi_rs_estimate(torch.as_tensor(rx), ct).numpy(),
            np_(jax.jit(lambda x: jcsi.csi_rs_estimate(x, cj))(jnp.asarray(rx))),
            rtol=0, atol=1e-5)


# ------------------------------------------------------------------ PDCCH

def _pdcch_cfgs(mod, al, n, **kw):
    return [mod.PdcchConfig(rnti=0x4601 + i, n_id=7, aggregation_level=al,
                            cce_index=al * i, payload_bits=40, **kw)
            for i in range(n)]


def test_pdcch_encode_process_blind_decode():
    """Three DCIs at aggregation level 2 on a 2-symbol CORESET: encode_dci
    bits equal; process and process_multi grids to GRID_ATOL; blind decode
    of the noisy CORESET: the same payload and ok as the reference for DCI
    0, every DCI's payload exact, and a wrong RNTI failing."""
    rng = np.random.default_rng(2)
    cj = _pdcch_cfgs(jpdcch, 2, 3, duration=2)
    ct = _pdcch_cfgs(tpdcch, 2, 3, duration=2)
    pay = rng.integers(0, 2, (3, 40), dtype=np.int8)
    np.testing.assert_array_equal(
        tpdcch.encode_dci(torch.as_tensor(pay[:1]), ct[0]).numpy(),
        np_(jax.jit(lambda p: jpdcch.encode_dci(p, cj[0]))(jnp.asarray(pay[:1]))))
    g1 = np_(jax.jit(lambda p: jpdcch.process(p, cj[1], 14, NSUBC))(
        jnp.asarray(pay[1:2])))
    np.testing.assert_allclose(tpdcch.process(torch.as_tensor(pay[1:2]), ct[1], 14,
                                              NSUBC).numpy(), g1, rtol=0, atol=GRID_ATOL)
    gm = np_(jax.jit(lambda p: jpdcch.process_multi(p, cj, 14, NSUBC))(
        jnp.asarray(pay)))
    np.testing.assert_allclose(tpdcch.process_multi(torch.as_tensor(pay), ct, 14,
                                                    NSUBC).numpy(), gm, rtol=0, atol=GRID_ATOL)
    rx = gm + cnoise(rng, gm.shape, 0.15) * (np.abs(gm) > 0)
    oj, okj = jax.jit(lambda g: jpdcch.blind_decode(g, cj[0]))(jnp.asarray(rx))
    for i in range(3):
        ot, okt = tpdcch.blind_decode(torch.as_tensor(rx), ct[i])
        if i == 0:
            np.testing.assert_array_equal(ot.numpy(), np_(oj))
            np.testing.assert_array_equal(okt.numpy(), np_(okj))
        assert bool(okt.all())
        np.testing.assert_array_equal(ot.numpy(), pay[i:i + 1])
    wrong = dataclasses.replace(ct[0], rnti=0x1234)
    assert not bool(tpdcch.blind_decode(torch.as_tensor(rx), wrong)[1].any())
    with pytest.raises(ValueError):
        tpdcch.process_multi(torch.as_tensor(pay[:2]), ct[:1] * 2, 14, NSUBC)


# -------------------------------------------------------------------- SSB

@pytest.mark.parametrize("kw", [dict(pci=1), dict(pci=500, ssb_index=3, sfn=77),
                                dict(pci=17, l_max=4, hrf=True, sfn=5,
                                     first_symbol=2, first_subcarrier=24)])
def test_ssb_pbch_encode_process_decode(kw):
    """pbch_encode bits equal; the block's grid to GRID_ATOL (amplitude
    0.8); the PBCH receive of a noisy block: the same payload and CRC flag
    as the reference, and the sent MIB."""
    cj, ct = jssb.SsbConfig(**kw), tssb.SsbConfig(**kw)
    rng = np.random.default_rng(kw["pci"])
    mib = rng.integers(0, 2, (1, 24), dtype=np.int8)
    np.testing.assert_array_equal(tssb.pbch_encode(torch.as_tensor(mib), ct).numpy(),
                                  np_(jax.jit(lambda m: jssb.pbch_encode(m, cj))(
                                      jnp.asarray(mib))))
    gj = np_(jax.jit(lambda m: jssb.process(m, cj, 14, NSUBC, amplitude=0.8))(
        jnp.asarray(mib)))
    gt = tssb.process(torch.as_tensor(mib), ct, 14, NSUBC, amplitude=0.8)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=GRID_ATOL)
    rx = gj + cnoise(rng, gj.shape, 0.1) * (np.abs(gj) > 0)
    pj, okj = jax.jit(lambda g: jssb.decode(g, cj))(jnp.asarray(rx))
    pt, okt = tssb.decode(torch.as_tensor(rx), ct)
    np.testing.assert_array_equal(pt.numpy(), np_(pj))
    np.testing.assert_array_equal(okt.numpy(), np_(okj))
    assert bool(okt.all())
    np.testing.assert_array_equal(pt.numpy(), mib)


# ------------------------------------------------------------------ polar

POLAR_SC_CODES = {   # (K, E, DCI/PBCH form, n_pc)
    "pbch": (56, 864, True, 0),
    "dci_al1": (64, 108, True, 0),
    "dci_al2": (64, 216, True, 0),
    "pc_12_48": (12, 48, False, 3),
    "pc_16_220": (16, 220, False, 3),   # the row-weight PC bit
}


def _construct(code_mod, k, e, dl, n_pc):
    """The DCI / PBCH codes are built with the call the PDCCH and SSB models
    make, so the reference's construct cache hands back the object those
    models use (two equal reference codes built apart cannot share its
    table caches)."""
    if dl:
        return code_mod.construct(k, e, nmax=code_mod.NMAX_DL, i_il=True)
    return code_mod.construct(k, e, nmax=code_mod.NMAX_UL, i_il=False, n_pc=n_pc)


@pytest.mark.parametrize("name", list(POLAR_SC_CODES))
def test_polar_sc_decode(name):
    """SC decode of noisy rate-matched codewords (8 per code, LLR 4 +- N(0,
    2)): the same bits as the reference's decoder."""
    k, e, dl, n_pc = POLAR_SC_CODES[name]
    cj, ct = _construct(jcode, k, e, dl, n_pc), _construct(tcode, k, e, dl, n_pc)
    rng = np.random.default_rng(k + e)
    msgs = rng.integers(0, 2, (8, k), dtype=np.int8)
    tx = np_(jax.jit(lambda m: jrm.rate_match(jenc.encode(m, cj), cj))(jnp.asarray(msgs)))
    llr = ((1.0 - 2.0 * tx) * 4.0 + rng.normal(size=tx.shape) * 2.0).astype(np.float32)
    dematch = jax.jit(lambda x: jrm.rate_dematch(x, cj))
    mother = np_(dematch(jnp.asarray(llr)))
    out_j = np_(jax.jit(lambda x: jdec.decode(x, cj))(jnp.asarray(mother)))
    out_t = tdec.decode(torch.as_tensor(mother), ct).numpy()
    np.testing.assert_array_equal(out_t, out_j)
    # Noiseless: the message itself.
    clean = np_(dematch(jnp.asarray((1.0 - 2.0 * tx) * 8.0)))
    np.testing.assert_array_equal(tdec.decode(torch.as_tensor(clean), ct).numpy(), msgs)


# ------------------------------------------- DM-RS, low PAPR, PSS / SSS

def test_dmrs_map_extract():
    """Pilots mapped at amplitude sqrt(2) on a (2, 14, nsubc) batch to
    GRID_ATOL; extraction returns them."""
    for cfg_type, port in ((1, 0), (1, 3), (2, 1)):
        pj = jdmrs.dmrs_pattern(cfg_type, 20, port)
        pt = tdmrs.dmrs_pattern(cfg_type, 20, port)
        ci = np.asarray([1234, 98765], np.int64)
        pil = np_(jdmrs.dmrs_sequence(jnp.asarray(ci.astype(np.uint32)),
                                      len(pj.subcarriers)))
        g0 = np.zeros((2, 14, 240), np.complex64)
        gj = np_(jdmrs.map_dmrs(jnp.asarray(g0), jnp.asarray(pil), pj, 3, np.sqrt(2)))
        gt = tdmrs.map_dmrs(torch.as_tensor(g0), torch.as_tensor(pil), pt, 3, np.sqrt(2))
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=GRID_ATOL)
        np.testing.assert_allclose(tdmrs.extract_dmrs(gt, pt, 3).numpy(),
                                   np_(jdmrs.extract_dmrs(jnp.asarray(gj), pj, 3)),
                                   rtol=0, atol=GRID_ATOL)


@pytest.mark.parametrize("m_zc", [12, 24, 36, 72, 288])
def test_low_papr_sequence(m_zc):
    for u, v, alpha in ((0, 0, 0.0), (7, 1 if m_zc >= 72 else 0, 1.3), (29, 0, 5.9)):
        np.testing.assert_allclose(
            tlp.low_papr_sequence(u, v, alpha, m_zc, device="cpu").numpy(),
            np_(jlp.low_papr_sequence(u, v, alpha, m_zc)), rtol=0, atol=GRID_ATOL)


def test_ssb_sync_map_and_pss_correlate():
    """PSS/SSS mapped to GRID_ATOL; the PSS correlator's magnitudes within
    1e-5 relative and the same N_ID2 decision on noisy symbols."""
    rng = np.random.default_rng(11)
    for pci in (0, 301, 1007):
        g0 = np.zeros((14, NSUBC), np.complex64)
        gj = np_(jsync.map_ssb_sync(jnp.asarray(g0), pci, 1, 48, amplitude=0.5))
        gt = tsync.map_ssb_sync(torch.as_tensor(g0), pci, 1, 48, amplitude=0.5)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=GRID_ATOL)
        rx = gj[1, 104:231] + cnoise(rng, (4, 127), 0.3)
        cj = np_(jsync.pss_correlate(jnp.asarray(rx)))
        ct = tsync.pss_correlate(torch.as_tensor(rx)).numpy()
        np.testing.assert_allclose(ct, cj, rtol=1e-5)
        assert (ct.argmax(-1) == pci % 3).all()
