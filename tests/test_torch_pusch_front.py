"""The PUSCH front's per-RE chain: ``ops/pusch_front.py`` and its CUDA
kernel ``pusch_demap`` (``csrc/pusch_front.cu``).

On the CPU: both UL fronts return int8 wire LLRs whose values are the
float32 chain's (derotation, ``equalize_mmse_1xn`` or
``mmse_equalize_timeinv_grid``, ``demodulate_soft``, ``wire_quantize``,
``scramble_llrs``) on the inputs the front hands to ``pusch_front.demap``:
the SISO front, the 2x2 and 4x4 fronts, the TA + smoothing estimator,
per-row inits (``ci=``), a DC erasure and one DM-RS symbol (no
derotation); the packed Gold words that the kernel reads, through a numpy
model of its per-CTA sequence window, give ``sequences.gold_sequence``.
The JAX package's comparisons of the fronts are in test_torch_slot_pipeline,
test_torch_mimo, test_torch_ta_chest and test_torch_multi_cell.

On the card (``-m cuda``; skipped on a host without a CUDA device; this
file imports no JAX): the kernel against the plain chain run on the card,
int8 LLR for int8 LLR, at both benchmark cells' shapes on 3 seeds, Qm 1 to
8, L = 1, 2, 4, an invalid RE erasing to 0, the TA front, per-row inits, a
block of slots as a mesh's rank takes it; the UL fronts on CUDA tensors
with the plain chain made to raise; one launch per full UL step.
"""

import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu_torch import cuda_build
from srsran_edgeric_5g_tpu_torch.device import host_constant
from srsran_edgeric_5g_tpu_torch.ops import (equalizer, modulation, pdsch_code,
                                             pusch_front, sequences)
from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm
from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as sp

torch.set_num_threads(2)

RNTIS = 0x4601 + np.arange(4, dtype=np.int64)
SISO, MIMO = fcm.FullCellConfig(), fcm.FullCellConfig(n_layers=2)


def _cell(mod="qam16", n_l=1, **kw):
    return sp.CellConfig(nof_prb=52, nfft=768, nof_ue=2, prb_per_ue=12, modulation=mod,
                         target_rate=0.4, n_layers=n_l, **kw)


# name -> the cell of a CPU case (S = 2 slots of its own waveform).
CPU_CASES = {
    "siso": _cell(),
    "siso_qam64_cell": sp.CellConfig(nof_prb=106, nfft=1536, nof_ue=4, prb_per_ue=24,
                                     modulation="qam64", target_rate=0.5, first_prb=4),
    "ta": _cell(delay_spread_us=1.0),
    "dc": _cell(dc_position=12 * 5 + 7),
    "one_dmrs": _cell("qpsk", dmrs_symbols=(2,)),
    "bpsk": _cell("bpsk"),
    "qam256": _cell("qam256"),
    "mimo2": _cell(n_l=2),
    "mimo4": _cell("qam64", n_l=4),
}


def _awgn(x, snr_db, rng):
    nv = float((np.abs(x) ** 2).mean()) * 10 ** (-snr_db / 10)
    noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    return (x + noise * np.sqrt(nv / 2)).astype(np.complex64)


def _received(cell, s, seed, device="cpu"):
    """(S, total) or (S, L, total) received samples of S slots of random
    payloads through 20 dB AWGN (a static LxL mix for L > 1) and their
    (U,) RNTIs."""
    rng = np.random.default_rng(seed)
    u, n_l = cell.nof_ue, cell.n_layers
    pay = rng.integers(0, 2, (s, u, cell.derived_tbs()), dtype=np.int8)
    rn = RNTIS[:u]
    if n_l == 1:
        td = sp.dl_slot_batch(pay, rn, cell, device=device).cpu().numpy()
        rx = _awgn(np.roll(td, 2, -1), 20.0, rng)
    else:
        td = sp.dl_slot_batch_mimo(pay, rn, cell, device=device).cpu().numpy()
        a = (rng.normal(size=(n_l, n_l)) + 1j * rng.normal(size=(n_l, n_l))) / np.sqrt(2)
        f = np.exp(-2j * np.pi * np.outer(np.arange(n_l), np.arange(n_l)) / n_l)
        mix = (0.35 * a + f / np.sqrt(n_l)).astype(np.complex64)
        rx = _awgn(np.einsum("pl,slt->spt", mix, td), 25.0, rng)
    return torch.as_tensor(rx, device=device), torch.as_tensor(rn, device=device)


def _front(cell, rx, rn, ci=None):
    if cell.n_layers > 1:
        return sp._ul_front_mimo(rx, rn, cell)
    return sp._ul_front(rx, None if ci is not None else rn, cell, ci=ci)


def _record(monkeypatch):
    """Every call of ``pusch_front.demap``: (args, its LLRs)."""
    calls, demap = [], pusch_front.demap

    def rec(*args):
        out = demap(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(pusch_front, "demap", rec)
    return calls


def _float_chain(grid, symbols, band0, u, eq, nv, rot, c_init, mod):
    """The float32 chain that the fronts ran before their LLRs became int8."""
    s, ndata = grid.shape[0], len(symbols)
    w = eq.shape[-1] if eq.ndim == 2 else eq.shape[2]
    band = grid[..., band0:band0 + u * w]
    if eq.ndim == 2:
        y = band[:, host_constant(symbols, grid.device)]
        y = y.reshape(s, ndata, u, w).permute(0, 2, 1, 3).reshape(s * u, ndata, w)
        if rot is not None:
            y = y * rot[:, :, None]
        x, nv_x = equalizer.equalize_mmse_1xn(y[None], eq[:, None, :].expand(y.shape)[None],
                                              nv[None, :, None, None])
        x, nv_x = x.reshape(s * u, -1), nv_x.reshape(s * u, -1)
    else:
        p = grid.shape[1]
        y = band[:, :, host_constant(symbols, grid.device)].reshape(s, p, ndata, u, w)
        if rot is not None:
            y = y * rot.reshape(s, u, ndata).transpose(1, 2)[:, None, :, :, None]
        x = equalizer.mmse_apply_grid(y, eq).permute(0, 2, 1, 3, 4)
        nv_x = nv[:, :, None].expand(x.shape)
    llr = modulation.demodulate_soft(x, nv_x, mod, quantize=False)
    llr = modulation.wire_quantize(llr, mod).reshape(s * u, -1)
    return sequences.scramble_llrs(llr, c_init)


@pytest.mark.parametrize("case", [*CPU_CASES, "siso_ci"])
def test_fronts_return_the_float_chains_values_as_int8(case, monkeypatch):
    cell = CPU_CASES["siso" if case == "siso_ci" else case]
    rx, rn = _received(cell, 2, seed=len(case))
    ci = (torch.as_tensor(np.random.default_rng(1).integers(0, 2 ** 31, 2 * cell.nof_ue))
          if case == "siso_ci" else None)
    calls = _record(monkeypatch)
    llr, nv, cfo = _front(cell, rx, rn, ci)
    assert llr.dtype == torch.int8 and nv.dtype == cfo.dtype == torch.float32
    assert len(calls) == 1
    args, out = calls[0]
    want = _float_chain(*args)
    assert want.dtype == torch.float32 and torch.equal(want, want.round())
    assert torch.equal(out.to(torch.float32), want)
    assert torch.equal(llr.reshape(out.shape), out)
    assert (args[6] is None) == (len(cell.dmrs_symbols) == 1)
    if case == "dc":
        # The DC subcarrier's REs erase in every slot, UE 0's row.
        k = cell.dc_position - cell.first_prb * 12
        ue, off = divmod(k, cell.ue_width_sc)
        per_re = cell.qm
        res = out.reshape(2, cell.nof_ue, len(cell.data_symbols), cell.ue_width_sc, per_re)
        assert (res[:, ue, :, off] == 0).all() and (res != 0).float().mean() > 0.9


def test_the_weights_split_is_the_grid_equaliser():
    """mmse_apply_grid(mmse_weights_grid) is mmse_equalize_timeinv_grid,
    and the weights are the per-subcarrier LxP MMSE of mmse_weights_lxn."""
    rng = np.random.default_rng(5)
    s, p, n_l, n, u, w = 2, 4, 4, 3, 2, 6
    c = lambda *sh: torch.as_tensor((rng.normal(size=sh) + 1j * rng.normal(size=sh))
                                    .astype(np.complex64))
    y, h = c(s, p, n, u, w), c(s, p, n_l, u, w)
    nv = torch.as_tensor(rng.uniform(0.01, 0.1, (s, p, u, 1)).astype(np.float32))
    wts, nv_out = equalizer.mmse_weights_grid(h, nv)
    assert wts.shape == (s, u, w, n_l, p) and nv_out.shape == (s, u, w, n_l)
    x, nv2 = equalizer.mmse_equalize_timeinv_grid(y, h, nv)
    assert torch.equal(x, equalizer.mmse_apply_grid(y, wts)) and torch.equal(nv2, nv_out)
    w_lxn, nv_lxn = equalizer.mmse_weights_lxn(h.permute(1, 2, 0, 3, 4),
                                              nv.permute(1, 0, 2, 3))
    torch.testing.assert_close(w_lxn, wts, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(nv_lxn, nv_out, rtol=1e-5, atol=0)


def _window_bits(x1, basis, ci, ndata, w, per_re, max_threads=256):
    """A numpy model of the kernel's sequence windows: each CTA (a run of
    a row's subcarriers) keeps, per data symbol, the words from the one
    holding its first LLR, made from the packed x1 word and basis rows;
    each RE reads its per_re bits from two of them -> the row's bits."""
    nwg = x1.shape[0]
    out = np.zeros(ndata * w * per_re, np.uint8)
    runs = -(-w // max_threads)
    kc = -(-w // runs)
    stride = ((31 + (kc - 1) * per_re) >> 5) + 2
    for k0 in range(0, w, kc):
        kn = min(kc, w - k0)
        nw = ((31 + (kn - 1) * per_re) >> 5) + 2
        assert nw <= stride
        for d in range(ndata):
            first = ((d * w + k0) * per_re) >> 5
            seq = np.zeros(nw, np.uint64)
            for idx in range(nw):
                gw = first + idx
                word = int(x1[gw]) if gw < nwg else 0
                for i in range(31):
                    if gw < nwg and (ci >> i) & 1:
                        word ^= int(basis[i * nwg + gw])
                seq[idx] = word
            for k in range(k0, k0 + kn):
                pos = (d * w + k) * per_re - first * 32
                win = (int(seq[(pos >> 5) + 1]) << 32 | int(seq[pos >> 5])) >> (pos & 31)
                for j in range(per_re):
                    out[(d * w + k) * per_re + j] = (win >> j) & 1
    return out


@pytest.mark.parametrize("ndata,w,per_re", [(11, 288, 6), (11, 288, 12), (10, 120, 1),
                                            (12, 1200, 32), (9, 300, 8), (11, 24, 2)])
def test_the_kernels_sequence_window_gives_gold_sequence(ndata, w, per_re):
    """The benchmark cells' rows (11 symbols of 288 subcarriers, 6 and 12
    LLRs an RE), a row wider than a CTA (1200 subcarriers in five runs of
    240) and the other widths of Qm x L: the words the kernel reads
    (``pdsch_code.gold_on``) and its windows give ``sequences.gold_sequence``
    for each row's init."""
    g = ndata * w * per_re
    x1, basis = (t.numpy().view(np.uint32) for t in pdsch_code.gold_on(g, torch.device("cpu")))
    for ci in (0, 2 ** 31 - 1, (0x4603 << 15) + 1, 123456789):
        want = sequences.gold_sequence(torch.tensor([ci]), g)[0].numpy()
        got = _window_bits(x1, basis.reshape(-1), ci, ndata, w, per_re)
        assert np.array_equal(got, want)


def test_demap_refuses_a_device_with_no_kernel():
    grid = torch.zeros((1, 14, 72), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="no pusch_demap kernel"):
        pusch_front.demap(grid, (3, 4), 0, 1, torch.zeros((1, 12), dtype=torch.complex64),
                          torch.zeros(1), None, torch.zeros(1, dtype=torch.int64), "qpsk")


# ------------------------------------------------------------- card tests

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pusch_demap kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_equals_plain(calls):
    """Each recorded demap call: the kernel's LLRs against the plain chain
    run on the card on the same inputs."""
    assert calls
    for args, out in calls:
        assert out.device.type == "cuda" and out.dtype == torch.int8
        ref = pusch_front.demap_plain(*args)
        diff = (out.to(torch.int16) - ref.to(torch.int16)).abs()
        assert int(diff.max()) == 0, (
            f"{int((diff > 0).sum())} of {diff.numel()} LLRs differ, max {int(diff.max())}")


def _cell_front(fc, s, seed, dev):
    """The UL front of a benchmark cell's UL configuration on S slots of
    its data-plane waveform."""
    cell = fc.ul_cell()
    rx, rn = _received(cell, s, seed, device=dev)
    return _front(cell, rx, rn)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("fc,s", [(SISO, 1024), (MIMO, 512)], ids=["siso", "mimo2x2"])
def test_kernel_equals_plain_chain_at_the_cells_shapes(cuda_device, fc, s, seed,
                                                       monkeypatch):
    calls = _record(monkeypatch)
    before = cuda_build.LAUNCHES[pusch_front.KERNEL]
    _cell_front(fc, s, seed, cuda_device)
    assert cuda_build.LAUNCHES[pusch_front.KERNEL] == before + 1
    _kernel_equals_plain(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("mod", ["bpsk", "qpsk", "qam16", "qam64", "qam256"])
@pytest.mark.parametrize("n_l", [1, 2, 4])
def test_kernel_equals_plain_chain_at_every_qm_and_layer_count(cuda_device, mod, n_l,
                                                               monkeypatch):
    """Qm 1 to 8 at one layer (the 1xN MMSE), and at 2 and 4 layers (the
    LxP weights), each with its own Gold windows (L * Qm LLRs an RE)."""
    cell = _cell(mod, n_l)
    rx, rn = _received(cell, 3, seed=n_l * 10 + cell.qm, device=cuda_device)
    calls = _record(monkeypatch)
    _front(cell, rx, rn)
    _kernel_equals_plain(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ta", "dc", "one_dmrs", "siso_ci", "weights_one_layer"])
def test_kernel_equals_plain_chain_on_every_front(cuda_device, case, monkeypatch):
    """The TA + smoothing front, an invalid RE (the DC position: a zero
    estimate erases to 0), one DM-RS symbol (no derotation), per-row inits
    as the multi-carrier path gives them, and the weights at one layer."""
    if case == "weights_one_layer":
        cell = _cell()
        rx, rn = _received(cell, 3, seed=7, device=cuda_device)
        calls = _record(monkeypatch)
        sp._ul_front_mimo(rx[:, None], rn, cell)
    else:
        cell = CPU_CASES["siso" if case == "siso_ci" else case]
        rx, rn = _received(cell, 3, seed=8, device=cuda_device)
        ci = (torch.as_tensor(np.random.default_rng(1).integers(0, 2 ** 31, 3 * cell.nof_ue),
                              device=cuda_device) if case == "siso_ci" else None)
        calls = _record(monkeypatch)
        _front(cell, rx, rn, ci)
    _kernel_equals_plain(calls)
    if case == "dc":
        out = calls[0][1].reshape(3, cell.nof_ue, len(cell.data_symbols), -1, cell.qm)
        ue, off = divmod(cell.dc_position - cell.first_prb * 12, cell.ue_width_sc)
        assert (out[:, ue, :, off] == 0).all()


@pytest.mark.cuda
def test_a_block_of_slots_gives_those_rows(cuda_device, monkeypatch):
    """A mesh's rank demaps the slots that hold its rows with their inits:
    the kernel on a block of slots gives those rows of the whole call."""
    cell = CPU_CASES["siso_qam64_cell"]
    rx, rn = _received(cell, 6, seed=9, device=cuda_device)
    calls = _record(monkeypatch)
    sp._ul_front(rx, rn, cell)
    (grid, symbols, band0, u, h, nv, rot, ci, mod), whole = calls[0]
    part = pusch_front.demap(grid[2:5], symbols, band0, u, h[2 * u:5 * u], nv[2 * u:5 * u],
                             rot[2 * u:5 * u], ci[2 * u:5 * u], mod)
    assert torch.equal(part, whole[2 * u:5 * u])


@pytest.mark.cuda
@pytest.mark.parametrize("n_l", [1, 2])
def test_fronts_on_the_card_run_no_plain_op(cuda_device, n_l, monkeypatch):
    cell = _cell("qam64", n_l)
    rx, rn = _received(cell, 2, seed=11, device=cuda_device)
    ref = _front(cell, rx, rn)[0]

    def plain(*a, **k):
        raise AssertionError("the plain chain ran on CUDA tensors")

    for mod, name in ((pusch_front, "demap_plain"), (equalizer, "equalize_mmse_1xn"),
                      (equalizer, "mmse_apply_grid"), (modulation, "demodulate_soft"),
                      (modulation, "wire_quantize"), (sequences, "scramble_llrs")):
        monkeypatch.setattr(mod, name, plain)
    assert torch.equal(_front(cell, rx, rn)[0], ref)


@pytest.mark.cuda
@pytest.mark.parametrize("fc", [SISO, MIMO], ids=["siso", "mimo2x2"])
def test_a_full_ul_step_launches_the_kernel_once(cuda_device, fc):
    from srsran_edgeric_5g_tpu_torch import bench
    s = 20
    x = bench.full_cell_inputs(fc, s, 25.0, cuda_device)
    rx = x["ul"] + x["noise"]
    x["gnb_ul"](rx, fc, s, device=cuda_device)
    torch.cuda.synchronize()
    before = cuda_build.LAUNCHES[pusch_front.KERNEL]
    res = x["gnb_ul"](rx, fc, s, device=cuda_device)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES[pusch_front.KERNEL] - before == 1
    assert res["tb_ok"].all()


@pytest.mark.cuda
def test_demap_raises_on_what_the_kernel_does_not_take(cuda_device):
    grid = torch.zeros((2, 14, 72), dtype=torch.complex64, device=cuda_device)
    h = torch.zeros((2, 12), dtype=torch.complex64, device=cuda_device)
    nv, ci = torch.ones(2, device=cuda_device), torch.zeros(2, dtype=torch.int64,
                                                            device=cuda_device)
    with pytest.raises(ValueError, match="eq must be"):
        pusch_front.demap(grid, (3, 4), 0, 1, h[:1], nv, None, ci, "qpsk")
    with pytest.raises(ValueError, match="data symbols must increase"):
        pusch_front.demap(grid, (4, 3), 0, 1, h, nv, None, ci, "qpsk")
    with pytest.raises(ValueError, match="UE span"):
        pusch_front.demap(grid, (3, 4), 66, 1, h, nv, None, ci, "qpsk")
    with pytest.raises(ValueError, match="rot must be"):
        pusch_front.demap(grid, (3, 4), 0, 1, h, nv, h, ci, "qpsk")
