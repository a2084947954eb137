"""Parity of the port's heterogeneous-allocation cell (models/hetero_cell.py)
with the JAX reference, and the grant layout / HARQ state carried across by
convert.py.

  * The scheduler's 4-UE grant set at 20 MHz (106 PRB; spans on the 8-PRB
    RBG grid, MCS from TS 38.214 Table 5.1.3.1-1; QPSK DFT-s-OFDM at BG2
    Zc = 26, 16QAM, 64QAM, and 64QAM r0.93 with one DM-RS symbol and an
    unequal E split) through both packages on the same numpy-noised samples,
    DL and UL: TX samples within 2e-6 of the peak; payloads and tb_ok
    equal and exact at 25 dB; noise variance within rtol 1e-4, CFO within
    1e-2 Hz; the float32 soft buffers equal but for ±1 wire steps in at
    most 1e-3 of the entries; then a chase-combined reception from the
    reference's soft buffers carried over by convert.soft_buffers_from_numpy.
  * tests/test_harq_retx.py's combined decode through the port alone.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.models import hetero_cell as jhc
from srsran_edgeric_5g_tpu.models import pdsch as jpd
from srsran_edgeric_5g_tpu.models import pusch as jpu
from srsran_edgeric_5g_tpu.ran import numerology as jnum
from srsran_edgeric_5g_tpu.ran import tbs as jtbs
from srsran_edgeric_5g_tpu_torch import convert
from srsran_edgeric_5g_tpu_torch.models import hetero_cell as thc
from srsran_edgeric_5g_tpu_torch.models import pdsch as tpd
from srsran_edgeric_5g_tpu_torch.models import pusch as tpu
from srsran_edgeric_5g_tpu_torch.ran import numerology as tnum
from srsran_edgeric_5g_tpu_torch.ran import tbs as ttbs

torch.set_num_threads(2)


def grant_set(pdsch, tbs):
    def grant(rnti, start, n, mcs, **kw):
        m = tbs.mcs_config(mcs, "qam64")
        return pdsch.PdschConfig(rnti=rnti, start_prb=start, nof_prb=n,
                                 modulation=m.modulation,
                                 target_rate=m.target_rate, **kw)
    return [grant(0x4601, 0, 4, 2, transform_precoding=True),
            grant(0x4602, 4, 24, 13),
            grant(0x4603, 28, 32, 20),
            grant(0x4604, 60, 46, 28, dmrs_symbols=(2,))]


def _awgn(x, snr_db, rng):
    x = np.asarray(x)
    nv = float((np.abs(x) ** 2).mean()) * 10 ** (-snr_db / 10)
    noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    return (x + noise * np.sqrt(nv / 2)).astype(np.complex64)


def _wire_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def _same_outs(got, want, payloads):
    assert len(got) == len(want) == len(payloads)
    for g, w, p in zip(got, want, payloads):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
        np.testing.assert_array_equal(g[0].numpy(), p)
        np.testing.assert_array_equal(g[1].numpy(), np.asarray(w[1]))
        assert g[1].all()
        np.testing.assert_allclose(g[2].numpy(), np.asarray(w[2]), rtol=1e-4)
        np.testing.assert_allclose(g[3].numpy(), np.asarray(w[3]), atol=1e-2)
        if len(g) > 4:
            _wire_close(g[4].numpy(), w[4])


def test_grant_set_20mhz_matches_reference():
    """DL (pdsch.process -> pdsch.receive) and UL (pusch.transmit ->
    pusch.process) of the 4-UE grant set through both packages; the soft
    buffers of both directions; a chase combine from the reference's
    buffers (convert.soft_buffers_from_numpy)."""
    jt = jnum.slot_timing(**jnum.CELL_20MHZ)
    tt = tnum.slot_timing(**tnum.CELL_20MHZ)
    jp = jhc.HeteroCellProcessor(jt, grant_set(jpd, jtbs))
    tp = thc.HeteroCellProcessor(tt, grant_set(tpd, ttbs), device="cpu")
    assert tp.tbs == jp.tbs == [184, 5504, 12808, 33816]
    segs = [tpd._plans(c)[0] for c in tp.ue_cfgs]
    assert [(s.bg, s.zc, s.c) for s in segs] == [(2, 26, 1), (1, 256, 1),
                                                 (1, 320, 2), (1, 320, 5)]
    assert segs[3].e == (7284, 7284, 7284, 7290, 7290)
    assert [tp.soft_buffer_shape(u) for u in range(4)] == \
        [jp.soft_buffer_shape(u) for u in range(4)]
    rng = np.random.default_rng(7)
    pay = [rng.integers(0, 2, (1, n), dtype=np.int8) for n in jp.tbs]
    zeros = [np.zeros(jp.soft_buffer_shape(u), np.float32) for u in range(4)]
    for tx_j, tx_t, rx_j, rx_t, plain_t in (
            (jp.process_dl_slot, tp.process_dl_slot, jp.process_dl_rx_harq_slot,
             tp.process_dl_rx_harq_slot, tp.process_dl_rx_slot),
            (jp.process_ul_tx_slot, tp.process_ul_tx_slot, jp.process_ul_harq_slot,
             tp.process_ul_harq_slot, tp.process_ul_slot)):
        td = np.asarray(tx_j([jnp.asarray(p) for p in pay]))
        got_td = tx_t([torch.as_tensor(p) for p in pay]).numpy()
        assert np.abs(got_td - td).max() <= 2e-6 * np.abs(td).max()
        rx = _awgn(td, 25.0, rng)
        want = rx_j(jnp.asarray(rx), [jnp.asarray(z) for z in zeros], (0,) * 4)
        got = rx_t(torch.as_tensor(rx), [torch.as_tensor(z) for z in zeros], (0,) * 4)
        _same_outs(got, want, pay)
        # Without soft buffers: the same outcome (zeros = no prior).
        for g, p in zip(plain_t(torch.as_tensor(rx)), got):
            for a, b in zip(g, p[:4]):
                assert torch.equal(a, b)
        # Chase combine of the same reception into the reference's buffers.
        soft = convert.soft_buffers_from_numpy([np.asarray(w[4]) for w in want],
                                               device="cpu")
        want2 = rx_j(jnp.asarray(rx), [w[4] for w in want], (0,) * 4)
        got2 = rx_t(torch.as_tensor(rx), soft, (0,) * 4)
        _same_outs(got2, want2, pay)


def test_harq_retx_combined_decode():
    """tests/test_harq_retx.py's operating point (10 MHz, 12 PRB 64QAM r0.8,
    6.5 dB both transmissions, numpy rng(0)) through the port: rv 0 fails,
    rv 2 from a zero buffer fails, the combined decode is exact."""
    t = tnum.slot_timing(**tnum.CELL_10MHZ)
    cfg = tpd.PdschConfig(rnti=0x4601, start_prb=0, nof_prb=12,
                          modulation="qam64", target_rate=0.8)
    proc = thc.HeteroCellProcessor(t, [cfg], device="cpu")
    rng = np.random.default_rng(0)
    pay = [torch.as_tensor(rng.integers(0, 2, (1, n), dtype=np.int8))
           for n in proc.tbs]
    zeros = [torch.zeros(proc.soft_buffer_shape(0))]
    rx1 = _awgn(proc.process_ul_tx_rv_slot(pay, (0,)), 6.5, rng)
    _, ok1, _, _, soft1 = proc.process_ul_harq_slot(rx1, zeros, (0,))[0]
    assert not ok1.any()
    rx2 = _awgn(proc.process_ul_tx_rv_slot(pay, (2,)), 6.5, rng)
    _, ok_fresh, *_ = proc.process_ul_harq_slot(rx2, zeros, (2,))[0]
    assert not ok_fresh.any()
    hat, ok_comb, _, _, soft2 = proc.process_ul_harq_slot(rx2, [soft1], (2,))[0]
    assert ok_comb.all() and torch.equal(hat, pay[0])
    assert soft2.dtype == torch.float32 and soft2.abs().sum() > soft1.abs().sum()


def test_harq_point_of_the_card_run():
    """chip_smoke.py's hetero_harq point: 20 MHz, 12 PRB 64QAM r0.8 at
    4.0 dB both transmissions, both directions; rv 0 and rv 2 fail alone and
    combine to the exact payload (here with a CPU torch.Generator; 12 of 12
    draws per direction did so when the point was picked)."""
    t = tnum.slot_timing(**tnum.CELL_20MHZ)
    cfg = tpd.PdschConfig(rnti=0x4601, start_prb=0, nof_prb=12,
                          modulation="qam64", target_rate=0.8)
    proc = thc.HeteroCellProcessor(t, [cfg], device="cpu")
    gen = torch.Generator().manual_seed(3)
    pay = [torch.randint(0, 2, (1, proc.tbs[0]), generator=gen, dtype=torch.int8)]
    zeros = [torch.zeros(proc.soft_buffer_shape(0))]

    def awgn(td):
        sigma = torch.sqrt(td.abs().pow(2).mean() * 10.0 ** (-4.0 / 10.0) / 2.0)
        return td + torch.complex(torch.randn(td.shape, generator=gen),
                                  torch.randn(td.shape, generator=gen)) * sigma

    for tx, rx in ((proc.process_ul_tx_rv_slot, proc.process_ul_harq_slot),
                   (proc.process_dl_rv_slot, proc.process_dl_rx_harq_slot)):
        _, ok1, _, _, soft1 = rx(awgn(tx(pay, (0,))), zeros, (0,))[0]
        rx2 = awgn(tx(pay, (2,)))
        _, ok_fresh, *_ = rx(rx2, zeros, (2,))[0]
        hat, ok_comb, *_ = rx(rx2, [soft1], (2,))[0]
        assert not ok1.any() and not ok_fresh.any()
        assert ok_comb.all() and torch.equal(hat, pay[0])


def test_overlap_rejected():
    t = tnum.slot_timing(**tnum.CELL_10MHZ)
    cfgs = [tpd.PdschConfig(rnti=1, start_prb=0, nof_prb=10),
            tpd.PdschConfig(rnti=2, start_prb=8, nof_prb=10)]
    with pytest.raises(ValueError):
        thc.HeteroCellProcessor(t, cfgs, device="cpu")
    with pytest.raises(AssertionError):
        jhc.HeteroCellProcessor(jnum.slot_timing(**jnum.CELL_10MHZ),
                                [jpd.PdschConfig(rnti=1, start_prb=0, nof_prb=10),
                                 jpd.PdschConfig(rnti=2, start_prb=8, nof_prb=10)])
    proc = thc.HeteroCellProcessor(t, cfgs[:1], device="cpu")
    with pytest.raises(ValueError):
        proc.process_dl_slot([])


def test_entry_point_defaults_to_the_card():
    t = tnum.slot_timing(**tnum.CELL_10MHZ)
    cfg = [tpd.PdschConfig(rnti=1, start_prb=0, nof_prb=10)]
    if torch.cuda.is_available():
        assert thc.HeteroCellProcessor(t, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            thc.HeteroCellProcessor(t, cfg)


def test_convert_round_trip():
    """Grant layouts, UCI configurations and per-UE soft buffers cross from
    the reference's dataclasses / arrays to the port's."""
    for jc, tc in zip(grant_set(jpd, jtbs), grant_set(tpd, ttbs)):
        got = convert.pdsch_config_from_dict(dataclasses.asdict(jc))
        assert got == tc and hash(got) == hash(tc)
    d = dataclasses.asdict(jpd.PdschConfig(rnti=3, nof_prb=8, start_prb=2,
                                           dmrs_symbols=[2, 7, 11]))
    assert convert.pdsch_config_from_dict(d).dmrs_symbols == (2, 7, 11)
    ju = jpu.UciConfig(n_ack=2, g_ack=32, g_ack_rvd=64, n_csi1=8, g_csi1=64)
    assert convert.uci_config_from_dict(dataclasses.asdict(ju)) == \
        tpu.UciConfig(n_ack=2, g_ack=32, g_ack_rvd=64, n_csi1=8, g_csi1=64)
    with pytest.raises(TypeError):
        convert.pdsch_config_from_dict({**dataclasses.asdict(jc), "bogus": 1})
    bufs = [np.arange(12, dtype=np.float32).reshape(2, 6), np.ones((1, 4), np.float32)]
    got = convert.soft_buffers_from_numpy(bufs, device="cpu")
    for g, b in zip(got, bufs):
        assert g.dtype == torch.float32 and np.array_equal(g.numpy(), b)
    with pytest.raises(ValueError):
        convert.soft_buffers_from_numpy([np.zeros((2, 3), np.int8)], device="cpu")
    with pytest.raises(ValueError):
        convert.soft_buffers_from_numpy([np.zeros(3, np.float32)], device="cpu")
