"""Parity of the port's control-channel modules with the JAX reference:
polar construction / encode / rate match, short-block encode and detect,
PDCCH rows and CCE-to-PRB tables, SSB blocks, PSS/SSS, low-PAPR, CSI-RS and
SRS sequences, PUCCH tables, PRACH roots and occasion processing, and the
amplitude controller.  Everything that is bits is compared exactly; the
float stages (PRACH demodulation and detection, amplitude metrics) within
the tolerances stated at each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.models import pdcch as jpdcch, ssb as jssb
from srsran_edgeric_5g_tpu.ops import amplitude as jamp, csi_rs as jcsi
from srsran_edgeric_5g_tpu.ops import low_papr as jlp, prach as jprach
from srsran_edgeric_5g_tpu.ops import pucch as jpucch, sequences as jseq
from srsran_edgeric_5g_tpu.ops import short_block as jsb, sync_signals as jsync
from srsran_edgeric_5g_tpu.ops.polar import code as jcode, encoder as jenc
from srsran_edgeric_5g_tpu.ops.polar import rate_match as jrm
from srsran_edgeric_5g_tpu.parallel import full_cell as jfc
from srsran_edgeric_5g_tpu_torch import convert
from srsran_edgeric_5g_tpu_torch.models import pdcch as tpdcch, ssb as tssb
from srsran_edgeric_5g_tpu_torch.ops import amplitude as tamp, csi_rs as tcsi
from srsran_edgeric_5g_tpu_torch.ops import low_papr as tlp, prach as tprach
from srsran_edgeric_5g_tpu_torch.ops import pucch as tpucch, sequences as tseq
from srsran_edgeric_5g_tpu_torch.ops import short_block as tsb
from srsran_edgeric_5g_tpu_torch.ops import sync_signals as tsync
from srsran_edgeric_5g_tpu_torch.ops.polar import code as tcode, encoder as tenc
from srsran_edgeric_5g_tpu_torch.ops.polar import rate_match as trm
from srsran_edgeric_5g_tpu_torch.parallel import full_cell as tfc

# Six test workers share the host with the JAX tests: two intra-op threads.
torch.set_num_threads(2)

POLAR_CODES = [  # (K, E, i_il, n_pc, i_bil): PDCCH AL1/AL2, PBCH, UCI forms
    (64, 108, True, 0, False), (64, 216, True, 0, False),
    (56, 864, True, 0, False), (29, 101, False, 0, False),
    (15, 203, False, 3, True), (19, 61, False, 3, False)]


def _construct(code_mod, k, e, i_il, n_pc, i_bil):
    """The DCI / PBCH codes are built with the call the PDCCH and SSB models
    make: the reference's construct cache then hands back the one object
    those models use (two equal reference codes built apart cannot share
    its table caches).  The UCI-form sizes are used nowhere else."""
    if i_il:
        return code_mod.construct(k, e, nmax=code_mod.NMAX_DL, i_il=True)
    return code_mod.construct(k, e, nmax=code_mod.NMAX_UL, i_il=False,
                              n_pc=n_pc, i_bil=i_bil)


@pytest.mark.parametrize("k,e,i_il,n_pc,i_bil", POLAR_CODES)
def test_polar_encode_rate_match(k, e, i_il, n_pc, i_bil):
    cj = _construct(jcode, k, e, i_il, n_pc, i_bil)
    ct = _construct(tcode, k, e, i_il, n_pc, i_bil)
    for f in ("info_set", "frozen_set", "subblock_perm", "pc_set"):
        np.testing.assert_array_equal(getattr(ct, f), getattr(cj, f))
    assert (ct.n, ct.rm_mode) == (cj.n, cj.rm_mode)
    msg = np.random.default_rng(k + e).integers(0, 2, (9, k), dtype=np.int8)
    u_j, x_j, cw_j, rm_j = (np.asarray(v) for v in jax.jit(lambda m: (
        jenc.allocate(m, cj), jenc.transform(jenc.allocate(m, cj)),
        jenc.encode(m, cj), jrm.rate_match(jenc.encode(m, cj), cj)))(msg))
    np.testing.assert_array_equal(tenc.allocate(torch.as_tensor(msg), ct).numpy(),
                                  u_j)
    np.testing.assert_array_equal(tenc.transform(torch.as_tensor(u_j)).numpy(), x_j)
    cw_t = tenc.encode(torch.as_tensor(msg), ct)
    np.testing.assert_array_equal(cw_t.numpy(), cw_j)
    np.testing.assert_array_equal(trm.rate_match(cw_t, ct).numpy(), rm_j)


@pytest.mark.parametrize("k", [1, 2, 3, 8, 11])
def test_short_block_encode_detect(k):
    """Encode bit-exact; detect on noisy LLRs: the same bits, the metric to
    float32 rounding (rtol 1e-5, a 32..2048-wide dot product)."""
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (12, k), dtype=np.int8)
    cw = tsb.encode(torch.as_tensor(bits), 32)
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jsb.encode(jnp.asarray(bits), 32)))
    llr = ((1 - 2 * cw.numpy().astype(np.float32)) * 2
           + rng.normal(size=cw.shape)).astype(np.float32)
    bj, mj = jsb.detect(jnp.asarray(llr), k)
    bt, mt = tsb.detect(torch.as_tensor(llr), k)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5)


def test_gold_and_sync_sequences():
    for ci in (0, 1, 0x4601 << 15 | 1, (1 << 31) - 1):
        np.testing.assert_array_equal(tseq.np_gold_sequence(ci, 300),
                                      jseq.np_gold_sequence(ci, 300))
    for n_id2 in range(3):
        np.testing.assert_array_equal(tsync.pss_sequence(n_id2), jsync.pss_sequence(n_id2))
        for n_id1 in (0, 111, 112, 335):
            np.testing.assert_array_equal(tsync.sss_sequence(n_id1, n_id2),
                                          jsync.sss_sequence(n_id1, n_id2))
    assert tsync.pci_to_nid(1007) == jsync.pci_to_nid(1007)


@pytest.mark.parametrize("m_zc", [6, 12, 18, 24, 36, 120, 288])
def test_low_papr_base_sequence(m_zc):
    for u, v in ((0, 0), (1, 0), (29, 0), (17, 1)):
        if v and m_zc < 72:
            continue
        np.testing.assert_array_equal(tlp.base_sequence(u, v, m_zc),
                                      jlp.base_sequence(u, v, m_zc))


def test_csi_rs_srs_and_pucch_tables():
    for cfg in (dict(scrambling_id=1, slot=2, symbol=1, start_prb=0, nof_prb=106),
                dict(scrambling_id=500, slot=7, symbol=5, start_prb=4, nof_prb=24,
                     density=3, comb_offset=2)):
        tc, jc = tcsi.CsiRsConfig(**cfg), jcsi.CsiRsConfig(**cfg)
        np.testing.assert_array_equal(tcsi.csi_rs_pilots(tc), jcsi.csi_rs_pilots(jc))
        np.testing.assert_array_equal(tcsi.csi_rs_subcarriers(tc),
                                      jcsi.csi_rs_subcarriers(jc))
    for cfg in (dict(sequence_id=1, slot=0, symbol=13, start_prb=4, nof_prb=96,
                     comb=4, comb_offset=3),
                dict(sequence_id=47, slot=0, symbol=13, start_prb=0, nof_prb=48,
                     comb=2, cyclic_shift=5)):
        tc, jc = tcsi.SrsConfig(**cfg), jcsi.SrsConfig(**cfg)
        np.testing.assert_array_equal(tcsi.srs_sequence(tc), jcsi.srs_sequence(jc))
        np.testing.assert_array_equal(tcsi.srs_subcarriers(tc), jcsi.srs_subcarriers(jc))
    for slot in (0, 3, 19):
        np.testing.assert_array_equal(tpucch._ncs_table(1, slot), jpucch._ncs_table(1, slot))
        tc = tpucch.Pucch01Config(n_id=1, slot=slot, start_symbol=0,
                                  nof_symbols=14, initial_cs=0)
        jc = jpucch.Pucch01Config(n_id=1, slot=slot, start_symbol=0,
                                  nof_symbols=14, initial_cs=0)
        for sym in (0, 5, 13):
            np.testing.assert_array_equal(tpucch._f0_sequence(tc, 3, sym),
                                          jpucch._f0_sequence(jc, 3, sym))
    np.testing.assert_array_equal(tpucch._occ(7, 2), jpucch._occ(7, 2))
    for n in (1, 2, 4):
        np.testing.assert_array_equal(tpucch._f2_data_sc(n), jpucch._f2_data_sc(n))
        np.testing.assert_array_equal(tpucch._f2_dmrs_sc(n), jpucch._f2_dmrs_sc(n))
    f2 = dict(rnti=0x4601, n_id=1, n_id0=3, slot=11, start_symbol=0,
              nof_symbols=2, start_prb=100, nof_prb=1, uci_bits=8)
    assert (tpucch._f2_dmrs_cinit(tpucch.Pucch2Config(**f2), 1)
            == jpucch._f2_dmrs_cinit(jpucch.Pucch2Config(**f2), 1))


PDCCH_CFGS = [
    dict(rnti=0x4601, n_id=1, aggregation_level=2, cce_index=4, coreset_start_prb=2,
         coreset_nof_prb=96, payload_bits=40, slot=3),
    dict(rnti=0x17, n_id=5, aggregation_level=4, cce_index=2, coreset_nof_prb=48,
         duration=2, interleaved=True, reg_bundle_size=2, interleaver_rows=3,
         shift_index=7),
    dict(rnti=0x1234, n_id=9, aggregation_level=1, cce_index=5, coreset_nof_prb=36,
         duration=3, interleaved=True, reg_bundle_size=6, interleaver_rows=2)]


@pytest.mark.parametrize("cfg", PDCCH_CFGS)
def test_pdcch_prb_tables(cfg):
    tc, jc = tpdcch.PdcchConfig(**cfg), jpdcch.PdcchConfig(**cfg)
    np.testing.assert_array_equal(tpdcch._alloc_prbs(tc), jpdcch._alloc_prbs(jc))
    (td, tm), (jd, jm) = tpdcch._re_positions(tc), jpdcch._re_positions(jc)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tpdcch._dmrs_values(tc, tm, 1),
                                  jpdcch._dmrs_values(jc, jm, 1))
    assert tpdcch._scrambling_cinit(tc) == jpdcch._scrambling_cinit(jc)
    assert [tpdcch.cce_to_bundle(tc, x) for x in range(8)] == \
        [jpdcch.cce_to_bundle(jc, x) for x in range(8)]


@pytest.fixture(scope="module")
def main_cell():
    jc = jfc.FullCellConfig()
    return jc, convert.full_cell_from_dict(dataclasses.asdict(jc))


def test_pdcch_rows_and_ssb_blocks(main_cell):
    """The full cell's batched PDCCH rows (S = 21: DM-RS of 21 slots) and
    SSB blocks (occasions at slots 0, 10, 20: SFN 0, 1, 2) at the 20 MHz
    cell, bit for bit (QPSK and pilot values are exact in float32)."""
    jc, tc = main_cell
    s = 21
    rng = np.random.default_rng(4)
    dci = rng.integers(0, 2, (s, 2 * jc.nof_ue, jc.dci_bits), dtype=np.int8)
    pbch = rng.integers(0, 2, (len(jc.ssb_slots(s)), 24), dtype=np.int8)
    np.testing.assert_array_equal(
        tfc.pdcch_rows(torch.as_tensor(dci), tc, s).numpy(),
        np.asarray(jax.jit(lambda d: jfc.pdcch_rows(d, jc, s))(dci)))
    np.testing.assert_array_equal(
        tfc.ssb_blocks(torch.as_tensor(pbch), tc, s).numpy(),
        np.asarray(jax.jit(lambda p: jfc.ssb_blocks(p, jc, s))(pbch)))
    np.testing.assert_array_equal(tfc._csi_rs_rows_np(tc, s), jfc._csi_rs_rows_np(jc, s))
    for sc in (tssb.SsbConfig(pci=1, l_max=4, sfn=2), tssb.SsbConfig(pci=57, l_max=64,
                                                                     ssb_index=13, sfn=77)):
        jcfg = jssb.SsbConfig(**dataclasses.asdict(sc))
        for a, b in zip(tssb._payload_maps(sc), jssb._payload_maps(jcfg)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tssb._seq2(sc), jssb._seq2(jcfg))


def test_prach_roots_and_detection(main_cell):
    """Roots, preamble table and occasion layout exactly; the occasion DFT
    (torch.fft, 18432 points) within 1e-5 of the peak and the detector's
    prime-length IDFT (torch.fft.ifft against the reference's IDFT matmul)
    with metrics within rtol 1e-4 and identical delays and detections."""
    jc, tc = main_cell
    for l_ra in (tprach.L_LONG, tprach.L_SHORT):
        for i in (0, 1, 100, l_ra - 2, l_ra + 5):
            assert tprach.sequence_number(i, l_ra) == jprach.sequence_number(i, l_ra)
    np.testing.assert_array_equal(tprach.root_sequence(129), jprach.root_sequence(129))
    for zcz in range(16):
        assert tprach.ncs_from_zcz(zcz) == jprach.ncs_from_zcz(zcz)
    assert tc.prach_cfg().preamble_table == jc.prach_cfg().preamble_table
    assert dataclasses.asdict(tc.prach_info()) == dataclasses.asdict(jc.prach_info())
    info = tc.prach_info()
    rng = np.random.default_rng(6)
    td = np.stack([jfc.prach_occasion_td(jc, p, delay=d, amplitude=1.0)
                   for p, d in ((7, 24), (40, 3), (63, 60))])
    # The port's occasion spans prach_span(delay) slots: one at these rates.
    occ = [tfc.prach_occasion_td(tc, p, delay=d, amplitude=1.0)
           for p, d in ((7, 24), (40, 3), (63, 60))]
    assert all(o.shape == (1, td.shape[-1]) for o in occ)
    np.testing.assert_array_equal(np.stack([o[0] for o in occ]), td)
    win = (td + 0.3 * (rng.normal(size=td.shape) + 1j * rng.normal(size=td.shape))
           ).astype(np.complex64)[:, :info.cp_samples + info.dft_size]
    fj = np.asarray(jprach.ofdm_demodulate_prach(jnp.asarray(win), jc.prach_info()))
    ft = tprach.ofdm_demodulate_prach(torch.as_tensor(win), info)
    assert np.abs(ft.numpy() - fj).max() < 1e-5 * np.abs(fj).max()
    mj, dj, detj = (np.asarray(x) for x in jax.jit(
        lambda f: jfc._prach_detect_batch(f, jc))(jnp.asarray(fj)))
    mt, dt, dett = (x.numpy() for x in tfc._prach_detect_batch(torch.as_tensor(fj), tc))
    np.testing.assert_allclose(mt, mj, rtol=1e-4)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(dett, detj)
    assert dett[0, 7] and dett[1, 40] and dett[2, 63] and dett.sum() == 3


def test_amplitude_controller():
    """scale / clip: samples and metrics to float32 rounding (rtol 1e-6)."""
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(3, 500)) + 1j * rng.normal(size=(3, 500))).astype(np.complex64)
    for (yt, mt), (yj, mj) in (
            (tamp.scale(torch.as_tensor(x), 0.7), jamp.scale(jnp.asarray(x), 0.7)),
            (tamp.clip(torch.as_tensor(x), 1.3, 1.5), jamp.clip(jnp.asarray(x), 1.3, 1.5))):
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6, atol=1e-7)
        for f in ("avg_power", "peak_power", "papr", "clipped_ratio"):
            np.testing.assert_allclose(float(getattr(mt, f)), float(getattr(mj, f)),
                                       rtol=1e-6)
        assert abs(mt.papr_db() - mj.papr_db()) < 1e-4
