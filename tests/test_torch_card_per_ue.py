"""The per-UE path on the card (``-m cuda``; these skip on a host without a
CUDA device): K1's f32 mode with the l <= 0 rule, which decode("auto")
launches, at every NR lifting size against its plain twin; and the
heterogeneous cell and the per-UE MIMO receiver on the card against their
CPU runs on the same input.  No JAX here: the CPU runs are the port's own,
which tests/test_torch_hetero_cell.py and tests/test_torch_mimo_ue.py hold
to the JAX package.

Tolerances: hard bits, ok, sweeps, payloads and tb_ok equal; noise variance
within rtol 1e-4, CFO within 1e-2 Hz; the float32 soft buffers (dematched
wire integers) equal but for ±1 steps in at most 1e-3 of the entries (the
card's FFT and reductions sum in another order).
"""

import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu_torch import cuda_build
from srsran_edgeric_5g_tpu_torch.models import hetero_cell, mimo, pdsch
from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder, decoder_cuda, encoder
from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph, lifting_sizes
from srsran_edgeric_5g_tpu_torch.ran import numerology, tbs

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the decoder kernel has no CPU mode)")
    return torch.device("cuda")


def _noisy_llrs(bg, zc, b, snr_db, seed):
    g = get_graph(bg, zc)
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, size=(b, g.k), dtype=np.int8)
    cw = encoder.encode(torch.as_tensor(msgs), bg, zc).numpy()
    sigma = 10 ** (-snr_db / 20)
    y = 1 - 2 * cw[:, 2 * zc:].astype(np.float32) + rng.normal(size=cw[:, 2 * zc:].shape) * sigma
    return np.concatenate([np.zeros((b, 2 * zc), np.float32), 2 * y / sigma ** 2],
                          axis=1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("zc", lifting_sizes())
@pytest.mark.parametrize("bg", [1, 2])
def test_f32_le_rule_kernel_matches_plain_every_lifting_size(cuda_device, bg, zc,
                                                             early_stop):
    """decode("auto")'s launch: f32 mode, l <= 0, every lifting size (Zc < 64
    too), with an all-erased codeblock among noisy ones (its posterior stays
    exactly zero, where the two hard rules differ)."""
    llr = _noisy_llrs(bg, zc, 4, snr_db=1.0, seed=bg * 1000 + zc)
    llr[1] = 0.0
    x = torch.as_tensor(llr, device=cuda_device)
    before = cuda_build.LAUNCHES[decoder_cuda.KERNEL]
    got = decoder_cuda.decode_layered(x, bg, zc, num_iters=5, wire=False,
                                      early_stop=early_stop, strict=False)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES[decoder_cuda.KERNEL] == before + 1
    want = decoder_cuda.decode_layered_plain(x, bg, zc, num_iters=5, wire=False,
                                             early_stop=early_stop, strict=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[0][1] == 1).all()
    auto = decoder.decode(x, bg, zc, num_iters=5, schedule="auto",
                          early_stop=early_stop)
    assert torch.equal(auto[0], got[0]) and torch.equal(auto[1], got[1])
    if zc >= decoder_cuda.MIN_ZC:           # decode_pallas' rule: post < 0
        strict = decoder_cuda.decode_layered(x, bg, zc, num_iters=5, wire=False,
                                             early_stop=early_stop)
        assert (strict[0][1] == 0).all()
    else:
        with pytest.raises(ValueError):
            decoder.decode(x, bg, zc, schedule="pallas")


def _grant_set():
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
    nv = float((np.abs(x) ** 2).mean()) * 10 ** (-snr_db / 10)
    return (x + (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
            * np.sqrt(nv / 2)).astype(np.complex64)


@pytest.mark.cuda
def test_hetero_cell_card_equals_cpu(cuda_device):
    """The 20 MHz 4-UE grant set, DL and UL, HARQ receive from zero buffers:
    the card (K1 in wire mode, 4 launches per direction) against the CPU."""
    t = numerology.slot_timing(**numerology.CELL_20MHZ)
    cpu = hetero_cell.HeteroCellProcessor(t, _grant_set(), device="cpu")
    card = hetero_cell.HeteroCellProcessor(t, _grant_set(), device=cuda_device)
    rng = np.random.default_rng(11)
    pay = [rng.integers(0, 2, (1, n), dtype=np.int8) for n in cpu.tbs]
    zeros = [np.zeros(cpu.soft_buffer_shape(u), np.float32) for u in range(4)]
    for tx_c, tx_g, rx_c, rx_g in (
            (cpu.process_dl_slot, card.process_dl_slot,
             cpu.process_dl_rx_harq_slot, card.process_dl_rx_harq_slot),
            (cpu.process_ul_tx_slot, card.process_ul_tx_slot,
             cpu.process_ul_harq_slot, card.process_ul_harq_slot)):
        td = tx_c(pay).numpy()
        td_g = tx_g(pay).cpu().numpy()
        assert np.abs(td_g - td).max() <= 1e-5 * np.abs(td).max()
        rx = _awgn(td, 25.0, rng)
        want = rx_c(rx, zeros, (0,) * 4)
        before = cuda_build.LAUNCHES[decoder_cuda.KERNEL]
        got = rx_g(rx, zeros, (0,) * 4)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES[decoder_cuda.KERNEL] == before + 4
        for g, w, p in zip(got, want, pay):
            assert torch.equal(g[0].cpu(), w[0]) and np.array_equal(w[0].numpy(), p)
            assert torch.equal(g[1].cpu(), w[1]) and w[1].all()
            np.testing.assert_allclose(g[2].cpu().numpy(), w[2].numpy(), rtol=1e-4)
            np.testing.assert_allclose(g[3].cpu().numpy(), w[3].numpy(), atol=1e-2)
            diff = (g[4].cpu() - w[4]).abs()
            assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n_l,nprb,start,snr_db", [(2, 52, 0, 27.0), (4, 36, 52, 30.0)])
def test_receive_mimo_card_equals_cpu(cuda_device, n_l, nprb, start, snr_db):
    """The per-UE MIMO receiver at chip_smoke.py's mimo_ue points: the card (K1 f32
    mode through decode("auto"), one launch) against the CPU."""
    t = numerology.slot_timing(**numerology.CELL_20MHZ)
    times = np.asarray(t.cp.data_starts) / t.srate
    cfg = pdsch.PdschConfig(rnti=0x4605, start_prb=start, nof_prb=nprb,
                            modulation="qam64", target_rate=0.5)
    rng = np.random.default_rng(n_l)
    pay = torch.as_tensor(rng.integers(0, 2, (1, mimo.derived_tbs(cfg, n_l)),
                                       dtype=np.int8))
    grids = mimo.process_mimo(pay, cfg, t.nsymb, t.nof_subc, n_layers=n_l).numpy()
    h = (np.eye(n_l) + 0.3 * (rng.normal(size=(n_l, n_l))
                              + 1j * rng.normal(size=(n_l, n_l)))).astype(np.complex64)
    rx = np.einsum("ap,psk->ask", h, grids)
    sig = float(np.mean(np.abs(rx[np.abs(rx) > 0]) ** 2))
    rx = (rx + (rng.normal(size=rx.shape) + 1j * rng.normal(size=rx.shape))
          * np.sqrt(sig * 10 ** (-snr_db / 10) / 2)).astype(np.complex64)
    want = mimo.receive_mimo(torch.as_tensor(rx), cfg, t.srate, times, n_layers=n_l)
    before = cuda_build.LAUNCHES[decoder_cuda.KERNEL]
    got = mimo.receive_mimo(torch.as_tensor(rx, device=cuda_device), cfg, t.srate,
                            times, n_layers=n_l)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES[decoder_cuda.KERNEL] == before + 1
    for f in ("payload", "tb_crc_ok", "cb_crc_ok"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f))
    assert torch.equal(want.payload, pay) and want.tb_crc_ok.all()
    np.testing.assert_allclose(got.noise_var.cpu().numpy(), want.noise_var.numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(got.cfo_hz.cpu().numpy(), want.cfo_hz.numpy(), atol=1e-2)
