"""The port's layered LDPC decoder kernel module (ops/ldpc/decoder_cuda.py).

On the CPU the module's plain version is held to the JAX reference: f32
mode to the Pallas kernel ``decode_pallas`` (run in the Pallas interpreter,
in a fresh subprocess as tests/test_ldpc_pallas.py does), wire mode to the
``layered_wire`` schedule.  Both comparisons are bit-exact (hard bits and
``ok``): the arithmetic is the same float32 / integer sequence.

The kernel itself runs only on a CUDA card; those tests carry the ``cuda``
marker and skip elsewhere.  A card's machine need not have JAX, so this
module imports the JAX package only inside the tests that compare with it,
and the card tests run without tests/conftest.py (which sets up JAX):
``python -m pytest --noconftest -o addopts="" -m cuda
tests/test_torch_ldpc_kernel.py``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu_torch import cuda_build
from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder_cuda, encoder
from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _noisy_llrs(bg, zc, b, snr_db, seed):
    """(messages, float32 LLRs incl. the punctured 2*Zc zeros) for BPSK
    codewords through AWGN (the port's encoder; test_torch_ldpc.py holds it
    bit-equal to the reference's)."""
    g = get_graph(bg, zc)
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, size=(b, g.k), dtype=np.int8)
    cw = encoder.encode(torch.as_tensor(msgs), bg, zc).numpy()
    sym = 1 - 2 * cw[:, 2 * zc:].astype(np.float32)
    sigma = 10 ** (-snr_db / 20)
    y = sym + rng.normal(size=sym.shape) * sigma
    llr = np.concatenate([np.zeros((b, 2 * zc), np.float32),
                          2 * y / sigma ** 2], axis=1).astype(np.float32)
    return msgs, llr


def _wire(llr):
    """int8 wire domain: clip ±20, scale to ±120 integer steps."""
    return np.clip(np.round(np.clip(llr, -20, 20) * 6.0), -120, 120).astype(np.int8)


_PALLAS_CHILD = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from srsran_edgeric_5g_tpu.ops.ldpc import decoder_pallas
llr = np.load(sys.argv[1])
hard, ok = decoder_pallas.decode_pallas(jnp.asarray(llr), 2, 128, num_iters=2,
                                        b_tile=8, interpret=True,
                                        early_stop=False)
np.savez(sys.argv[2], hard=np.asarray(hard), ok=np.asarray(ok))
"""


def test_f32_plain_matches_pallas_interpret(tmp_path):
    """f32 mode == decode_pallas (Pallas interpreter) at BG2, Zc=128, B=8,
    2 sweeps; bit-exact hard bits and ok."""
    _, llr = _noisy_llrs(2, 128, 8, snr_db=1.0, seed=5)
    np.save(tmp_path / "llr.npy", llr)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-c", _PALLAS_CHILD, str(tmp_path / "llr.npy"),
         str(tmp_path / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(tmp_path / "out.npz")
    hard, ok, sweeps = decoder_cuda.decode_layered(
        torch.as_tensor(llr), 2, 128, num_iters=2, wire=False, early_stop=False)
    np.testing.assert_array_equal(hard.numpy(), ref["hard"])
    np.testing.assert_array_equal(ok.numpy(), ref["ok"])
    assert (sweeps.numpy() == 2).all()


@pytest.mark.parametrize("bg,zc", [(1, 64), (2, 128), (1, 224)])
def test_wire_plain_matches_layered_wire(bg, zc):
    """Wire mode == layered_wire with fixed sweeps: bit-exact."""
    import jax.numpy as jnp
    from srsran_edgeric_5g_tpu.ops.ldpc import decoder as jdec
    _, llr = _noisy_llrs(bg, zc, 3, snr_db=0.5, seed=bg * 100 + zc)
    q = _wire(llr)
    hj, okj = jdec.decode(jnp.asarray(q.astype(np.float32)), bg, zc,
                          num_iters=3, schedule="layered_wire", early_stop=False)
    hard, ok, _ = decoder_cuda.decode_layered(
        torch.as_tensor(q), bg, zc, num_iters=3, wire=True, early_stop=False)
    np.testing.assert_array_equal(hard.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))


def test_wire_plain_early_stop_per_codeblock():
    """Per-codeblock early stop: every codeblock decodes its message and
    stops at its own sweep count; a stopped codeblock equals a fixed-sweep
    decode of that many sweeps (its state is frozen, not advanced)."""
    bg, zc = 2, 128
    msgs, llr = _noisy_llrs(bg, zc, 6, snr_db=2.0, seed=9)
    q = torch.as_tensor(_wire(llr))
    hard, ok, sweeps = decoder_cuda.decode_layered(q, bg, zc, num_iters=8,
                                                   wire=True, early_stop=True)
    assert ok.all()
    np.testing.assert_array_equal(hard.numpy(), msgs)
    assert sweeps.min() >= 1 and sweeps.max() <= 8
    for i in range(6):
        n = int(sweeps[i])
        h1, ok1, _ = decoder_cuda.decode_layered(q[i:i + 1], bg, zc, num_iters=n,
                                                 wire=True, early_stop=False)
        np.testing.assert_array_equal(h1.numpy()[0], hard.numpy()[i])


def test_input_checks():
    q = torch.zeros((2, get_graph(2, 128).n_full), dtype=torch.int8)
    with pytest.raises(TypeError):
        decoder_cuda.decode_layered(q.float(), 2, 128, wire=True)
    with pytest.raises(TypeError):
        decoder_cuda.decode_layered(q, 2, 128, wire=False)
    with pytest.raises(ValueError):
        decoder_cuda.decode_layered(q[:, :-1], 2, 128, wire=True)


def test_module_imports_without_nvcc():
    """Importing the kernel module (and decoding a CPU tensor) compiles and
    loads nothing, even with no nvcc reachable."""
    code = ("import json, torch\n"
            "from srsran_edgeric_5g_tpu_torch import cuda_build\n"
            "from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder_cuda as d\n"
            "q = torch.zeros((1, 52 * 128), dtype=torch.int8)\n"
            "h, ok, s = d.decode_layered(q, 2, 128, num_iters=1, wire=True)\n"
            "print(json.dumps({'libs': len(cuda_build._libs),"
            " 'launches': sum(cuda_build.LAUNCHES.values())}))\n")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env.update(PATH=os.path.dirname(sys.executable), PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "libs": 0, "launches": 0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [True, False])
@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("bg,zc,b", [(1, 224, 64), (2, 128, 32), (1, 384, 8),
                                     (1, 64, 16)])
def test_kernel_matches_plain(cuda_device, bg, zc, b, wire, early_stop):
    """The CUDA kernel == its plain version on the card: hard bits, ok and
    per-codeblock sweep counts, bit for bit."""
    _, llr = _noisy_llrs(bg, zc, b, snr_db=1.0, seed=zc + b)
    x = torch.as_tensor(_wire(llr) if wire else llr, device=cuda_device)
    before = cuda_build.LAUNCHES[decoder_cuda.KERNEL]
    got = decoder_cuda.decode_layered(x, bg, zc, num_iters=5, wire=wire,
                                      early_stop=early_stop)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES[decoder_cuda.KERNEL] == before + 1
    want = decoder_cuda.decode_layered_plain(x, bg, zc, num_iters=5, wire=wire,
                                             early_stop=early_stop)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
