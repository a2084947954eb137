"""Parity of the port's CellProcessor with the JAX reference's: each scenario
of tests/test_cell_processor.py, run through both processors on the same
inputs.

The DL samples (``td``) are float stages and are compared within
TD_RTOL_OF_PEAK of the slot's peak magnitude; the UL of both processors then takes the same
received samples (the reference's DL plus numpy AWGN), and every bit-level
output must be equal: payloads, CRC flags, the HARQ pool's per-(rnti, pid)
soft buffers and transmission counts, UCI bits, PRACH detections and
delays.  Symbol-level metrics are held to the tolerances stated beside them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.models import cell_processor as jcp
from srsran_edgeric_5g_tpu.ops import csi_rs as jcsi, prach as jprach
from srsran_edgeric_5g_tpu.ops import pucch as jpucch
from srsran_edgeric_5g_tpu.parallel import slot_pipeline as jsp
from srsran_edgeric_5g_tpu_torch.models import cell_processor as tcp
from srsran_edgeric_5g_tpu_torch.ops import csi_rs as tcsi, prach as tprach
from srsran_edgeric_5g_tpu_torch.ops import pucch as tpucch
from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as tsp

# Six test workers share the host with the JAX tests: two intra-op threads.
torch.set_num_threads(2)

CELL = dict(nof_prb=52, nfft=768, nof_ue=2, prb_per_ue=12,
            modulation="qam16", target_rate=0.4)
# DL samples: float32 iDFTs of the same grids in two FFT libraries, compared
# against the slot's peak magnitude.
TD_RTOL_OF_PEAK = 1e-5
# Per-UE metrics of the same received samples: the noise variance and SINR
# come from float32 reductions in another order; below NV_ATOL (the SINR's
# clamp, 120 dB) a noiseless slot's variance is round-off.  The CFO is a
# phase over ~0.5 ms, so it is compared absolutely.
NV_RTOL = 1e-4
NV_ATOL = 1e-12
CFO_ATOL_HZ = 0.5


def pair(cell_kw=None, **kw):
    """(reference processor, port processor) on one cell description."""
    c = dict(CELL, **(cell_kw or {}))
    return (jcp.CellProcessor(jsp.CellConfig(**c), pci=5, **kw),
            tcp.CellProcessor(tsp.CellConfig(**c), pci=5, device="cpu", **kw))


def assert_td_close(td_t, td_j):
    td_j = np.asarray(td_j)
    peak = float(np.abs(td_j).max())
    np.testing.assert_allclose(td_t.numpy(), td_j, rtol=0,
                               atol=TD_RTOL_OF_PEAK * peak)


def awgn(td, snr_db, seed):
    td = np.asarray(td)
    nv = float((np.abs(td) ** 2).mean()) * 10 ** (-snr_db / 10)
    r = np.random.default_rng(seed)
    noise = r.normal(size=td.shape) + 1j * r.normal(size=td.shape)
    return (td + noise * np.sqrt(nv / 2)).astype(np.complex64)


def ul_both(jproc, tproc, rx, **kw):
    """The same received samples through both processors' UL: equal payloads
    and CRC flags; returns the CRC flags."""
    hat_j, ok_j = jproc.process_ul_slot(jnp.asarray(rx), **kw)
    hat_t, ok_t = tproc.process_ul_slot(torch.as_tensor(np.array(rx)), **kw)
    np.testing.assert_array_equal(hat_t.numpy(), np.asarray(hat_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    return np.asarray(ok_j)


def assert_metrics_equal(jproc, tproc):
    hj, ht = list(jproc.metrics.history), list(tproc.metrics.history)
    assert len(hj) == len(ht)
    for mj, mt in zip(hj, ht):
        assert mj.slot == mt.slot
        for uj, ut in zip(mj.ues, mt.ues):
            assert (uj.rnti, uj.tb_crc_ok, uj.tbs, uj.dl_bytes, uj.ul_bytes) == \
                (ut.rnti, ut.tb_crc_ok, ut.tbs, ut.dl_bytes, ut.ul_bytes)
            np.testing.assert_allclose(ut.noise_var, uj.noise_var, rtol=NV_RTOL,
                                       atol=NV_ATOL)
            # SINR = -10 log10(nv): NV_RTOL relative is 4.3e-4 dB.
            np.testing.assert_allclose(ut.sinr_db, uj.sinr_db, rtol=0,
                                       atol=10 * NV_RTOL)
            np.testing.assert_allclose(ut.cfo_hz, uj.cfo_hz, rtol=0,
                                       atol=CFO_ATOL_HZ)


def assert_pools_equal(jproc, tproc, pid):
    """The HARQ pools hold bit-equal buffers and equal counts for every UE."""
    for r in tproc.rntis.tolist():
        hj, ht = jproc.harq.get(r, pid), tproc.harq.get(r, pid)
        assert ht.tx_count == hj.tx_count
        assert (ht.soft_buffer is None) == (hj.soft_buffer is None)
        if hj.soft_buffer is not None:
            assert ht.soft_buffer.dtype == torch.int8
            np.testing.assert_array_equal(ht.soft_buffer.numpy(),
                                          np.asarray(hj.soft_buffer))


def test_dl_ul_slot_loop_with_metrics():
    jproc, tproc = pair()
    assert tproc.tbs == jproc.tbs
    rng = np.random.default_rng(0)
    for _ in range(3):
        payloads = rng.integers(0, 2, (2, tproc.tbs), dtype=np.int8)
        td_j = jproc.process_dl_slot(jnp.asarray(payloads))
        assert_td_close(tproc.process_dl_slot(torch.as_tensor(payloads)), td_j)
        assert ul_both(jproc, tproc, np.asarray(td_j)).all()
    assert_metrics_equal(jproc, tproc)
    assert len(list(tproc.metrics.history)) == 3
    assert tproc.metrics.throughput_mbps() == jproc.metrics.throughput_mbps()
    assert all(v > 0 for v in tproc.metrics.throughput_mbps().values())


def test_ssb_and_pdcch_overlay_keeps_pdsch_decodable():
    """SSB + PDCCH overlaid on the PDSCH in the time domain (the cell span
    sits above the SSB, as in the reference's test)."""
    rng = np.random.default_rng(1)
    jproc, tproc = pair(dict(first_prb=24, first_symbol=4, nof_symbols=10,
                             dmrs_symbols=(4, 11)), ssb_period_slots=1)
    payloads = rng.integers(0, 2, (2, tproc.tbs), dtype=np.int8)
    mib = rng.integers(0, 2, (1, 24), dtype=np.int8)
    dci = rng.integers(0, 2, (1, 40), dtype=np.int8)
    td_j = jproc.process_dl_slot(jnp.asarray(payloads), mib=jnp.asarray(mib),
                                 dci=jnp.asarray(dci))
    td_t = tproc.process_dl_slot(torch.as_tensor(payloads),
                                 mib=torch.as_tensor(mib), dci=torch.as_tensor(dci))
    assert_td_close(td_t, td_j)
    assert ul_both(jproc, tproc, np.asarray(td_j)).all()
    assert_metrics_equal(jproc, tproc)


def test_harq_pool_rv_progression():
    seqs = []
    for mod in (jcp, tcp):
        pool = mod.HarqPool()
        h = pool.get(0x4601, 0)
        rvs = [h.next_rv()]
        for _ in range(4):
            h.tx_count += 1
            rvs.append(h.next_rv())
        h.reset()
        assert h.next_rv() == 0 and h.soft_buffer is None
        assert pool.get(0x4601, 0) is h
        assert pool.get(0x4601, mod.NOF_HARQ) is h   # pid wraps
        seqs.append(rvs)
    assert seqs[1] == seqs[0] == [0, 2, 3, 1, 1]
    assert tcp.NOF_HARQ == jcp.NOF_HARQ


def test_prach_pucch_srs_occasions():
    """UL control-plane occasions through both processors' hooks."""
    jproc, tproc = pair()
    rng = np.random.default_rng(5)

    # PRACH: preamble 9 alone; detections and delays equal, metrics within
    # 1e-4 relative (float32 IDFTs of 839 points).  10 dB of AWGN makes every
    # zone's peak a property of the input: without it the 63 empty zones
    # hold round-off, whose argmax no two FFT libraries share.
    pj = jprach.PrachConfig(root_sequence_index=1, zero_correlation_zone=13)
    pt = tprach.PrachConfig(root_sequence_index=1, zero_correlation_zone=13)
    info = jprach.prach_ofdm_info(jproc.cell.timing.srate, pj.l_ra)
    tx = awgn(jprach.ofdm_modulate_prach(jprach.generate(pj, 9), info), 10.0, 6)
    dj = jproc.process_prach_occasion(jnp.asarray(tx), pj)
    dt = tproc.process_prach_occasion(torch.as_tensor(tx), pt)
    np.testing.assert_array_equal(dt.detected.numpy(), np.asarray(dj.detected))
    np.testing.assert_array_equal(dt.delays.numpy(), np.asarray(dj.delays))
    np.testing.assert_allclose(dt.metrics.numpy(), np.asarray(dj.metrics),
                               rtol=1e-4)
    d = dt.detected.numpy()
    assert d[9] and d.sum() == 1

    # PUCCH F2: 5-bit UCI; equal grids (to 1e-6), bits and ok equal.
    kw = dict(rnti=0x4601, n_id=31, n_id0=7, slot=0, start_symbol=12,
              nof_symbols=2, start_prb=0, nof_prb=4, uci_bits=5)
    uj, ut = jpucch.Pucch2Config(**kw), tpucch.Pucch2Config(**kw)
    bits = rng.integers(0, 2, (1, 5), dtype=np.int8)
    nsubc = tproc.cell.timing.nof_subc
    grid_j = np.asarray(jpucch.format2_process(jnp.asarray(bits), uj, 14, nsubc))
    grid_t = tpucch.format2_process(torch.as_tensor(bits), ut, 14, nsubc)
    np.testing.assert_allclose(grid_t.numpy(), grid_j, rtol=0, atol=1e-6)
    out_j, ok_j = jproc.process_pucch(jnp.asarray(grid_j), uj)
    out_t, ok_t = tproc.process_pucch(torch.as_tensor(grid_j), ut)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(out_t.numpy(), bits)

    # SRS: a flat channel of gain 0.8; |h| to 1e-5 as in the reference test,
    # and both estimates equal to 1e-6.  The clean grid's SNR is round-off
    # (above 100 dB in both); test_torch_control_single holds it on a noisy
    # grid.
    skw = dict(sequence_id=3, slot=0, symbol=13, start_prb=0, nof_prb=8, comb=2)
    sj, st = jcsi.SrsConfig(**skw), tcsi.SrsConfig(**skw)
    grid = tcsi.map_srs(torch.zeros((14, nsubc), dtype=torch.complex64), st) * 0.8
    h_j, snr_j = jproc.process_srs(jnp.asarray(grid.numpy()), sj)
    h_t, snr_t = tproc.process_srs(grid, st)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.abs(h_t.numpy()), 0.8, atol=1e-5)
    assert float(snr_t) > 100 and float(snr_j) > 100


@pytest.mark.parametrize("fresh_ue1", [False, True])
def test_cell_harq_retransmission_combines(fresh_ue1, monkeypatch):
    """rv 0 at too low an SNR fails for a UE; the rv 2 retransmission
    soft-combines through the pipeline's HARQ carry and decodes.  Both
    processors' pools hold bit-equal buffers after each transmission.

    ``fresh_ue1``: UE 1's process is reset between the two (as if its TB
    had decoded), so the whole-cell buffer is UE 0's int8 carry next to
    float32 zeros — the reference's promotion to a float32 buffer, which the
    port keeps (it reaches ul_slot as float32)."""
    jproc, tproc = pair(dict(target_rate=0.6))
    rng = np.random.default_rng(4)
    payloads = rng.integers(0, 2, (2, tproc.tbs), dtype=np.int8)
    snr_db = 3.2  # the reference test's point: too low for one-shot r0.6

    def tx(rv, seed):
        td_j = jproc.process_dl_slot(jnp.asarray(payloads), rv=rv)
        assert_td_close(tproc.process_dl_slot(torch.as_tensor(payloads), rv=rv),
                        td_j)
        return awgn(td_j, snr_db, seed)

    ok1 = ul_both(jproc, tproc, tx(0, 1), pid=3, rv=0)
    assert not ok1.all(), "first tx unexpectedly passed"
    assert_pools_equal(jproc, tproc, 3)
    assert any(tproc.harq.get(r, 3).soft_buffer is not None
               for r in tproc.rntis.tolist())
    if fresh_ue1:
        assert not ok1[1]
        jproc.harq.get(0x4602, 3).reset()
        tproc.harq.get(0x4602, 3).reset()
    seen = []
    ul_slot = tcp.sp.ul_slot

    def spy(*a, **kw):
        seen.append(kw["soft_buffer"].dtype)
        return ul_slot(*a, **kw)

    monkeypatch.setattr(tcp.sp, "ul_slot", spy)
    ok2 = ul_both(jproc, tproc, tx(2, 2), pid=3, rv=2)
    assert seen == [torch.float32 if fresh_ue1 else torch.int8]
    assert_pools_equal(jproc, tproc, 3)
    assert_metrics_equal(jproc, tproc)
    if fresh_ue1:
        assert ok2[0], "UE 0's combined retransmission must decode"
        return
    assert ok2.all(), "combined retransmission must decode"
    assert all(tproc.harq.get(r, 3).soft_buffer is None
               for r in tproc.rntis.tolist())


def test_cell_pucch_f0_f1_occasions():
    """F0 (sequence-detect SR/ACK) and F1 (OCC BPSK) occasions through both
    processors' hooks on the same noisy grids: equal sequences (to 1e-6),
    equal decisions, metrics within 1e-5."""
    jproc, tproc = pair()
    t = tproc.cell.timing
    rng = np.random.default_rng(8)

    kw0 = dict(n_id=5, slot=0, start_symbol=12, nof_symbols=2, initial_cs=0, prb=1)
    c0j, c0t = jpucch.Pucch01Config(**kw0), tpucch.Pucch01Config(**kw0)
    seq_j = np.asarray(jpucch.format0_generate(c0j, m0=6))
    seq_t = tpucch.format0_generate(c0t, m0=6, device="cpu")
    np.testing.assert_allclose(seq_t.numpy(), seq_j, rtol=0, atol=1e-6)
    grid = np.zeros((t.nsymb, t.nof_subc), np.complex64)
    grid[12:14, 12:24] = seq_j
    noise = (rng.normal(size=grid.shape) + 1j * rng.normal(size=grid.shape)) * 0.1
    rx = (grid + noise).astype(np.complex64)
    m_j, best_j = jproc.process_pucch_f0(jnp.asarray(rx), c0j, (0, 3, 6, 9))
    m_t, best_t = tproc.process_pucch_f0(torch.as_tensor(rx), c0t, (0, 3, 6, 9))
    assert int(best_t) == int(best_j) == 2   # m0 = 6
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-5)

    kw1 = dict(n_id=5, slot=0, start_symbol=4, nof_symbols=8, initial_cs=3, prb=2)
    c1j, c1t = jpucch.Pucch01Config(**kw1), tpucch.Pucch01Config(**kw1)
    grid_j = np.asarray(jpucch.format1_process(np.array([1]), c1j, t.nsymb,
                                               t.nof_subc, occ_index=1))
    grid_t = tpucch.format1_process(np.array([1]), c1t, t.nsymb, t.nof_subc,
                                    occ_index=1, device="cpu")
    np.testing.assert_allclose(grid_t.numpy(), grid_j, rtol=0, atol=1e-6)
    noise = (rng.normal(size=grid_j.shape) + 1j * rng.normal(size=grid_j.shape)) * 0.1
    rx = (grid_j + noise).astype(np.complex64)
    b_j, met_j = jproc.process_pucch_f1(jnp.asarray(rx), c1j, nof_bits=1, occ_index=1)
    b_t, met_t = tproc.process_pucch_f1(torch.as_tensor(rx), c1t, nof_bits=1,
                                        occ_index=1)
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    assert b_t.numpy().ravel()[0] == 1
    np.testing.assert_allclose(float(met_t), float(met_j), rtol=1e-5)


@pytest.mark.parametrize("mode", ["scale", "clip"])
def test_amplitude_controller_wired_into_tx(mode):
    """The DL transmit tail passes through the amplitude controller in scale
    mode (gain 0.5) and clipping mode (a ceiling below the peak): equal
    samples within TD_RTOL_OF_PEAK, the power and PAPR metrics within 1e-5
    relative, the clipped share equal, the decode equal."""
    rng = np.random.default_rng(3)
    payloads = rng.integers(0, 2, (2, pair()[1].tbs), dtype=np.int8)
    if mode == "scale":
        kw = dict(tx_gain=0.5)
    else:
        ref = jcp.CellProcessor(jsp.CellConfig(**CELL), pci=5, tx_gain=0.5)
        ceiling = float(np.abs(np.asarray(
            ref.process_dl_slot(jnp.asarray(payloads)))).max()) * 1.6
        kw = dict(tx_gain=1.0, tx_ceiling=ceiling)
    jproc, tproc = pair(**kw)
    td_j = jproc.process_dl_slot(jnp.asarray(payloads))
    td_t = tproc.process_dl_slot(torch.as_tensor(payloads))
    assert_td_close(td_t, td_j)
    ok = ul_both(jproc, tproc, np.asarray(td_j))
    mj, mt = list(jproc.metrics.history)[-1], list(tproc.metrics.history)[-1]
    np.testing.assert_allclose(mt.tx_avg_power, mj.tx_avg_power, rtol=1e-5)
    np.testing.assert_allclose(mt.tx_papr_db, mj.tx_papr_db, rtol=1e-5)
    assert mt.tx_clipped_ratio == mj.tx_clipped_ratio
    assert mt.to_dict().keys() == mj.to_dict().keys()
    assert np.isfinite(mt.tx_avg_power) and mt.tx_avg_power > 0
    if mode == "scale":
        assert ok.all() and mt.tx_clipped_ratio == 0.0
    else:
        assert mt.tx_clipped_ratio > 0
        assert float(td_t.abs().max()) <= kw["tx_ceiling"] * 1.0001
