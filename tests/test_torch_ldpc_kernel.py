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
tests/test_torch_ldpc_kernel.py tests/test_torch_ldpc_int8.py``.
"""

import fcntl
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
# Six test workers share the host with the JAX tests: two intra-op threads.
torch.set_num_threads(2)


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


# The Pallas interpreter runs in a fresh child process (in-process interpret
# compiles segfault, see tests/test_ldpc_pallas.py), once per test run for
# both kernels: K1's decode_pallas and K2's decode_pallas_int8 cases.
_PALLAS_CHILD = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from srsran_edgeric_5g_tpu.ops.ldpc import decoder_pallas
inp = np.load(sys.argv[1])
out = {}
hard, ok = decoder_pallas.decode_pallas(jnp.asarray(inp["f32"]), 2, 128,
                                        num_iters=2, b_tile=8, interpret=True,
                                        early_stop=False)
out["f32_hard"], out["f32_ok"] = np.asarray(hard), np.asarray(ok)
for b_tile, early_stop in INT8_CASES:
    hard, ok = decoder_pallas.decode_pallas_int8(
        jnp.asarray(inp["int8"]), 2, 64, num_iters=3, b_tile=b_tile,
        interpret=True, early_stop=early_stop)
    out[f"int8_{b_tile}_{int(early_stop)}_hard"] = np.asarray(hard)
    out[f"int8_{b_tile}_{int(early_stop)}_ok"] = np.asarray(ok)
np.savez(sys.argv[2], **out)
"""
# decode_pallas_int8 (BG2, Zc=64, B=16, 3 sweeps) cases run in the child:
# (b_tile, early_stop).  Without early stop the result does not depend on
# b_tile, so one tile size stands for both.
INT8_CASES = ((16, False), (8, True), (16, True))


def int8_reference_input():
    """(16, 52*64) float32 LLRs: codeblocks 0-7 at 8 dB, 8-15 at 1 dB, so
    two tiles of 8 stop after different numbers of sweeps."""
    bg, zc = 2, 64
    g = get_graph(bg, zc)
    rng = np.random.default_rng(11)
    msgs = rng.integers(0, 2, size=(16, g.k), dtype=np.int8)
    cw = encoder.encode(torch.as_tensor(msgs), bg, zc).numpy()
    sym = 1 - 2 * cw[:, 2 * zc:].astype(np.float32)
    sigma = 10 ** (-np.repeat([8.0, 1.0], 8)[:, None] / 20)
    y = sym + rng.normal(size=sym.shape) * sigma
    llr = np.concatenate([np.zeros((16, 2 * zc)), 8 * y / sigma ** 2], axis=1)
    return msgs, llr.astype(np.float32)


def pallas_reference(tmp_path_factory):
    """The child's outputs (an NpzFile), computed once per test run and
    shared by the xdist workers through a locked file."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    out = root / "pallas_reference.npz"
    with open(root / "pallas_reference.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            inp = root / "pallas_reference_input.npz"
            np.savez(inp, f32=_noisy_llrs(2, 128, 8, snr_db=1.0, seed=5)[1],
                     int8=int8_reference_input()[1])
            env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
            code = _PALLAS_CHILD.replace("INT8_CASES", repr(INT8_CASES))
            proc = subprocess.run(
                [sys.executable, "-c", code, str(inp), str(root / "tmp.npz")],
                env=env, capture_output=True, text=True, timeout=900, cwd=REPO)
            assert proc.returncode == 0, proc.stderr[-3000:]
            os.replace(root / "tmp.npz", out)
    return np.load(out)


@pytest.fixture(scope="module")
def pallas_ref(tmp_path_factory):
    return pallas_reference(tmp_path_factory)


def test_f32_plain_matches_pallas_interpret(pallas_ref):
    """f32 mode == decode_pallas (Pallas interpreter) at BG2, Zc=128, B=8,
    2 sweeps; bit-exact hard bits and ok."""
    _, llr = _noisy_llrs(2, 128, 8, snr_db=1.0, seed=5)
    hard, ok, sweeps = decoder_cuda.decode_layered(
        torch.as_tensor(llr), 2, 128, num_iters=2, wire=False, early_stop=False)
    np.testing.assert_array_equal(hard.numpy(), pallas_ref["f32_hard"])
    np.testing.assert_array_equal(ok.numpy(), pallas_ref["f32_ok"])
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


def test_wire_early_stop_per_codeblock_matches_batch_rule():
    """The card's wire_auto early stop is per codeblock (each CTA stops at
    its own zero syndrome, which decode_layered_plain mirrors); the JAX
    layered_wire schedule stops the whole batch once every codeword meets
    parity, so a codeblock that converged early keeps sweeping there.  On
    192 codeblocks of BG1 Zc=224 wire input (rate 0.5 after puncturing the
    tail, half at 3.0 dB, half at 2.5 dB, where codeblocks converge after 4,
    5 or 6 sweeps and some never do) both rules give the same hard bits and
    the same ok."""
    import jax.numpy as jnp
    from srsran_edgeric_5g_tpu.ops.ldpc import decoder as jdec
    bg, zc, b = 1, 224, 192
    g = get_graph(bg, zc)
    rng = np.random.default_rng(21)
    msgs = rng.integers(0, 2, size=(b, g.k), dtype=np.int8)
    cw = encoder.encode(torch.as_tensor(msgs), bg, zc).numpy()
    sym = 1 - 2 * cw[:, 2 * zc:].astype(np.float32)
    sigma = 10 ** (-np.repeat([3.0, 2.5], b // 2)[:, None] / 20)
    y = sym + rng.normal(size=sym.shape) * sigma
    llr = np.concatenate([np.zeros((b, 2 * zc)), 2 * y / sigma ** 2], axis=1)
    llr[:, 2 * zc + 9504:] = 0          # the main path's E = 9504
    q = _wire(llr)
    hj, okj = jdec.decode(jnp.asarray(q.astype(np.float32)), bg, zc,
                          num_iters=6, schedule="layered_wire", early_stop=True)
    hard, ok, sweeps = decoder_cuda.decode_layered_plain(
        torch.as_tensor(q), bg, zc, num_iters=6, wire=True, early_stop=True)
    assert len(np.unique(sweeps.numpy())) >= 3      # the rules can differ
    assert not np.asarray(okj).all()                # the batch runs 6 sweeps
    np.testing.assert_array_equal(hard.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))


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
