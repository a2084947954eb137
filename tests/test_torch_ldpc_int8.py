"""K2, the int8-state layered decoder (ops/ldpc/decoder_cuda.decode_int8).

On the CPU its plain twin ``decode_int8_plain`` is held bit for bit (hard
bits and ``ok``) to the JAX package's ``decode_pallas_int8`` run in the
Pallas interpreter: BG2, Zc=64, B=16, 3 sweeps, b_tile 8 and 16, early stop
off and on.  The interpreter runs once per test run in the child processes
of tests/test_torch_ldpc_kernel.py (``pallas_reference``), beside K1's case.
Codeblocks 0-7 of the input converge sooner than 8-15, so with b_tile 8 the
two tiles stop at different sweeps.

The kernel itself runs only on a CUDA card; those tests carry the ``cuda``
marker and skip elsewhere (``python -m pytest --noconftest -o addopts=""
-m cuda tests/test_torch_ldpc_int8.py`` on the card).
"""

import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu_torch import cuda_build
from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder_cuda
from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph
from test_torch_ldpc_kernel import (INT8_CASES, _noisy_llrs,
                                    int8_reference_input, pallas_reference)

# Six test workers share the host with the JAX tests: two intra-op threads.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pallas_ref(tmp_path_factory):
    return pallas_reference(tmp_path_factory)


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("b_tile", [8, 16])
def test_int8_plain_matches_pallas_interpret(pallas_ref, b_tile, early_stop):
    _, llr = int8_reference_input()
    hard, ok = decoder_cuda.decode_int8(torch.as_tensor(llr), 2, 64,
                                        num_iters=3, b_tile=b_tile,
                                        early_stop=early_stop)
    ref_tile = b_tile if (b_tile, early_stop) in INT8_CASES else 16
    key = f"int8_{ref_tile}_{int(early_stop)}"
    np.testing.assert_array_equal(hard.numpy(), pallas_ref[key + "_hard"])
    np.testing.assert_array_equal(ok.numpy(), pallas_ref[key + "_ok"])


def test_int8_tiles_stop_at_different_sweeps(pallas_ref):
    """b_tile 8: the first tile stops a sweep before the second, every
    codeblock of a tile runs the same sweeps, and the output is still the
    interpreter's; b_tile 16 runs the whole batch as long as its slowest
    codeblock."""
    msgs, llr = int8_reference_input()
    x = torch.as_tensor(llr)
    hard, ok, sweeps = decoder_cuda.decode_int8(x, 2, 64, 3, 8, True,
                                                with_sweeps=True)
    s = sweeps.numpy().reshape(2, 8)
    assert (s == s[:, :1]).all() and s[0, 0] < s[1, 0]
    np.testing.assert_array_equal(hard.numpy(), pallas_ref["int8_8_1_hard"])
    np.testing.assert_array_equal(hard.numpy(), msgs)
    _, _, sweeps16 = decoder_cuda.decode_int8(x, 2, 64, 3, 16, True,
                                              with_sweeps=True)
    assert (sweeps16.numpy() == s.max()).all()


def test_int8_input_conversion_and_checks():
    """Input: clip(round(llrs), ±127) with round half to even; an integer
    input passes unchanged.  Zc < 64 and B % b_tile != 0 raise."""
    g = get_graph(2, 64)
    vals = torch.tensor([2.5, -0.5, 1.5, 200.0, -300.0, -2.5, -128.0])
    x = torch.zeros((2, g.n_full))
    x[:, :7] = vals
    conv = decoder_cuda._int8_input(x, 2, 64, 1)
    assert conv.dtype == torch.int8
    assert conv[0, :7].tolist() == [2, 0, 2, 127, -127, -2, -127]
    assert torch.equal(decoder_cuda._int8_input(x.to(torch.int8), 2, 64, 1),
                       decoder_cuda._int8_input(x.to(torch.int8).float(), 2, 64, 1))
    h_f, ok_f = decoder_cuda.decode_int8(x, 2, 64, num_iters=2, b_tile=2)
    h_i, ok_i = decoder_cuda.decode_int8(conv, 2, 64, num_iters=2, b_tile=2)
    assert torch.equal(h_f, h_i) and torch.equal(ok_f, ok_i)
    with pytest.raises(ValueError):
        decoder_cuda.decode_int8(torch.zeros((2, 52 * 32)), 2, 32, b_tile=1)
    with pytest.raises(ValueError):
        decoder_cuda.decode_int8(x, 2, 64, b_tile=4)
    with pytest.raises(ValueError):
        decoder_cuda.decode_int8(x[:, :-1], 2, 64, b_tile=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("b_tile", [1, 8, 32])
@pytest.mark.parametrize("bg,zc,b,snr_db", [(1, 384, 64, 1.5), (2, 64, 32, 1.0),
                                            (1, 224, 96, 1.2)])
def test_int8_kernel_matches_plain(cuda_device, bg, zc, b, snr_db, b_tile,
                                   early_stop):
    """The kernel == its plain version on the card: hard bits, ok and the
    sweeps run per codeblock, bit for bit; one counted launch per call."""
    _, llr = _noisy_llrs(bg, zc, b, snr_db=snr_db, seed=zc + b)
    x = torch.as_tensor(np.clip(llr * 4, -127, 127), device=cuda_device)
    before = cuda_build.LAUNCHES[decoder_cuda.KERNEL_INT8]
    got = decoder_cuda.decode_int8(x, bg, zc, 5, b_tile, early_stop,
                                   with_sweeps=True)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES[decoder_cuda.KERNEL_INT8] == before + 1
    want = decoder_cuda.decode_int8_plain(x, bg, zc, 5, b_tile, early_stop,
                                          with_sweeps=True)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("num_iters", [0, 1, 2])
def test_int8_kernel_tile_exit_edges(cuda_device, num_iters):
    """The tiled path at few sweeps (0 sweeps runs none) and a tile count of
    one: the kernel == its plain version."""
    _, llr = int8_reference_input()
    x = torch.as_tensor(llr, device=cuda_device)
    for b_tile in (8, 16):
        got = decoder_cuda.decode_int8(x, 2, 64, num_iters, b_tile, True,
                                       with_sweeps=True)
        want = decoder_cuda.decode_int8_plain(x, 2, 64, num_iters, b_tile, True,
                                              with_sweeps=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
