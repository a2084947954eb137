"""The multi-layer UL front and the TA + smoothing UL front on the card
against their CPU runs on the same input (``-m cuda``; they skip on a host
without a CUDA device).  No JAX here: the CPU runs are the port's own,
which tests/test_torch_mimo.py and tests/test_torch_ta_chest.py hold to the
JAX package.

Tolerances as there: payload and tb_ok equal, noise_var within rtol 1e-4,
cfo within 1e-2 Hz, a ±1 wire-LLR step in at most 1e-3 of the entries (the
card's FFT and reductions sum in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as tsp

torch.set_num_threads(2)

RNTIS = 0x4601 + np.arange(4, dtype=np.int64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the decoder kernel has no CPU mode)")
    return torch.device("cuda")


def _awgn(x, snr_db, rng):
    nv = float((np.abs(x) ** 2).mean()) * 10 ** (-snr_db / 10)
    noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    return (x + noise * np.sqrt(nv / 2)).astype(np.complex64)


def _same_front(cpu, card):
    (llr_c, nv_c, cfo_c), (llr_g, nv_g, cfo_g) = cpu, [x.cpu() for x in card]
    diff = (llr_c - llr_g).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3
    np.testing.assert_allclose(nv_g.numpy(), nv_c.numpy(), rtol=1e-4)
    np.testing.assert_allclose(cfo_g.numpy(), cfo_c.numpy(), atol=1e-2)


def _same_decode(cpu, card):
    for c, g in zip(cpu[:2], card[:2]):
        assert torch.equal(c, g.cpu())
    assert cpu[1].all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_l", [2, 4])
def test_ul_front_mimo_card_equals_cpu(cuda_device, n_l):
    cell = tsp.CellConfig(nof_prb=52, nfft=768, nof_ue=2, prb_per_ue=20,
                          modulation="qam16", target_rate=0.5, n_layers=n_l)
    rng = np.random.default_rng(n_l)
    pay = rng.integers(0, 2, (2, 2, cell.derived_tbs()), dtype=np.int8)
    td = tsp.dl_slot_batch_mimo(pay, RNTIS[:2], cell, device="cpu").numpy()
    a = (rng.normal(size=(n_l, n_l)) + 1j * rng.normal(size=(n_l, n_l))) / np.sqrt(2)
    f = np.exp(-2j * np.pi * np.outer(np.arange(n_l), np.arange(n_l)) / n_l)
    mix = (0.35 * a + f / np.sqrt(n_l)).astype(np.complex64)
    rx = torch.as_tensor(_awgn(np.einsum("pl,slt->spt", mix, td), 25.0, rng))
    rn = torch.as_tensor(RNTIS[:2])
    _same_front(tsp._ul_front_mimo(rx, rn, cell),
                tsp._ul_front_mimo(rx.to(cuda_device), rn.to(cuda_device), cell))
    _same_decode(tsp.ul_slot_batch_mimo(rx, rn, cell, device="cpu"),
                 tsp.ul_slot_batch_mimo(rx, rn, cell, device=cuda_device))


@pytest.mark.cuda
def test_ul_front_ta_card_equals_cpu(cuda_device):
    cell = tsp.CellConfig(nof_prb=52, nfft=768, nof_ue=4, prb_per_ue=12,
                          modulation="qam16", target_rate=0.4)
    cell = dataclasses.replace(cell, delay_spread_us=1.0)
    rng = np.random.default_rng(6)
    pay = rng.integers(0, 2, (2, 4, cell.derived_tbs()), dtype=np.int8)
    td = np.roll(tsp.dl_slot_batch(pay, RNTIS, cell, device="cpu").numpy(), 2, -1)
    rx = torch.as_tensor(_awgn(td, 20.0, rng))
    rn = torch.as_tensor(RNTIS)
    _same_front(tsp._ul_front(rx, rn, cell),
                tsp._ul_front(rx.to(cuda_device), rn.to(cuda_device), cell))
    _same_decode(tsp.ul_slot_batch(rx, rn, cell, device="cpu"),
                 tsp.ul_slot_batch(rx, rn, cell, device=cuda_device))
