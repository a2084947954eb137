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
from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder, decoder_cuda, encoder
from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph, lifting_sizes

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


@pytest.mark.parametrize("bg,zc", [(1, 64), (2, 128), (1, 224), (2, 2), (1, 15),
                                   (2, 36), (1, 52)])
def test_wire_plain_matches_layered_wire(bg, zc):
    """Wire mode == layered_wire with fixed sweeps: bit-exact, also at the
    lifting sizes under 64 that wire mode takes on the card."""
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


def test_cuda_support_rule():
    """The card takes every NR lifting size in wire mode and keeps
    decode_pallas' Zc >= 64 floor for the f32 and int8 modes; every row
    degree of both base graphs has a row routine."""
    for zc in lifting_sizes():
        assert decoder_cuda.cuda_supported(zc, decoder_cuda.MODE_WIRE)
        for mode in (decoder_cuda.MODE_F32, decoder_cuda.MODE_INT8):
            assert decoder_cuda.cuda_supported(zc, mode) == (zc >= 64)
        for bg in (1, 2):
            assert set(decoder_cuda._row_degrees(bg, zc)) <= decoder_cuda.ROW_DEGREES
    assert not decoder_cuda.cuda_supported(385, decoder_cuda.MODE_WIRE)


@pytest.mark.parametrize("bg", [1, 2])
def test_row_barriers_separate_rows_sharing_a_column(bg):
    """The kernel skips the barrier between rows with no column in common:
    every row that shares a column with a row since the last barrier comes
    after a barrier, the last row ends with one, and rows are skipped."""
    g = get_graph(bg, 224)
    sync = decoder_cuda.row_barriers(bg, 224)
    cols = [set(g.edge_col[g.edge_row == r].tolist()) for r in range(g.rows)]
    assert sync[-1] == 1 and 0 < sync.sum() < g.rows
    since = set()
    for r in range(g.rows):
        assert not cols[r] & since
        since = set() if sync[r] else since | cols[r]
    assert np.array_equal(sync, decoder_cuda.row_barriers(bg, 40))


@pytest.mark.parametrize("bg,zc", [(1, 224), (2, 40)])
def test_wire_posterior_stays_int8(bg, zc):
    """The kernel stores wire-mode L as int8: the plain wire decode keeps
    every posterior an integer within ±127 after every sweep, on noisy input
    at 0-3 dB and on inputs saturated at the ±64 load clamp."""
    g = get_graph(bg, zc)
    plan = decoder.get_decode_plan(bg, zc)
    rng = np.random.default_rng(zc)
    inputs = [_wire(_noisy_llrs(bg, zc, 2, snr_db=snr, seed=zc + i)[1])
              for i, snr in enumerate((0.0, 1.0, 2.0, 3.0))]
    inputs.append(np.where(rng.random((4, g.n_full)) < 0.5, 64, -64).astype(np.int8))
    for q in inputs:
        l, r_msgs = decoder.init_state(torch.as_tensor(q), plan, True)
        for _ in range(6):
            decoder.sweep(l, r_msgs, bg, zc, decoder.DEFAULT_SCALING, True)
            assert float(l.abs().max()) <= 127
            assert torch.equal(l, l.round())


@pytest.mark.parametrize("mode", [decoder_cuda.MODE_WIRE, decoder_cuda.MODE_F32,
                                  decoder_cuda.MODE_INT8])
@pytest.mark.parametrize("bg,zc", [(1, 64), (2, 40)])
def test_compressed_messages_round_trip(bg, zc, mode):
    """The compressed per-row form of R that the kernel keeps (two scaled
    magnitudes, the first minimum's index, a sign bit per edge) rebuilds the
    per-edge messages of the plain decoders exactly after three sweeps:
    decode_layered_plain's wire and f32 modes and decode_int8_plain."""
    plan = decoder.get_decode_plan(bg, zc)
    _, llr = _noisy_llrs(bg, zc, 3, snr_db=0.5, seed=7 * zc)
    if mode == decoder_cuda.MODE_INT8:
        l = torch.as_tensor(np.clip(np.round(llr * 4), -127, 127)).to(torch.int16)
        r_msgs = torch.zeros((3, plan.rows, plan.max_deg, zc), dtype=torch.int8)
        for _ in range(3):
            decoder_cuda._sweep_int8(l, r_msgs, bg, zc)
    else:
        wire = mode == decoder_cuda.MODE_WIRE
        l, r_msgs = decoder.init_state(
            torch.as_tensor(_wire(llr) if wire else llr), plan, wire)
        for _ in range(3):
            decoder.sweep(l, r_msgs, bg, zc, decoder.DEFAULT_SCALING, wire)
    words, big = decoder_cuda.pack_messages(r_msgs, bg, zc, mode)
    assert int(words.max()) < 1 << 32 and int(words.min()) >= 0
    back = decoder_cuda.unpack_messages(words, big, bg, zc, mode, r_msgs.dtype)
    if mode == decoder_cuda.MODE_F32:      # bit for bit, -0.0 included
        back, r_msgs = back.view(torch.int32), r_msgs.view(torch.int32)
    assert torch.equal(back, r_msgs)


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


@pytest.mark.cuda
@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("zc", lifting_sizes())
@pytest.mark.parametrize("bg", [1, 2])
def test_wire_kernel_matches_plain_every_lifting_size(cuda_device, bg, zc,
                                                      early_stop):
    """Wire mode on the card at every NR lifting size of both base graphs
    (whole warps with idle lanes when Zc is not a multiple of 32, unaligned
    rows below 16 bytes): the kernel == its plain version, 5 sweeps."""
    _, llr = _noisy_llrs(bg, zc, 4, snr_db=1.0, seed=bg * 1000 + zc)
    x = torch.as_tensor(_wire(llr), device=cuda_device)
    got = decoder_cuda.decode_layered(x, bg, zc, num_iters=5, wire=True,
                                      early_stop=early_stop)
    want = decoder_cuda.decode_layered_plain(x, bg, zc, num_iters=5, wire=True,
                                             early_stop=early_stop)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("zc", [288, 320, 352])
def test_wire_kernel_matches_plain_at_main_path_widths(cuda_device, zc):
    """Wire mode at the BG1 lifting sizes of the 256QAM full slot (288),
    the 2x2 MIMO full slot (320) and the 4x4 data plane (352), on 2048
    codeblocks: the kernel == its plain version, early stop and 6 fixed
    sweeps."""
    _, llr = _noisy_llrs(1, zc, 2048, snr_db=1.5, seed=zc)
    x = torch.as_tensor(_wire(llr), device=cuda_device)
    for early_stop in (True, False):
        got = decoder_cuda.decode_layered(x, 1, zc, num_iters=6, wire=True,
                                          early_stop=early_stop)
        want = decoder_cuda.decode_layered_plain(x, 1, zc, num_iters=6, wire=True,
                                                 early_stop=early_stop)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("bg,zc", [(2, 40), (1, 15), (2, 2)])
def test_wire_auto_small_lifting_size_on_card(cuda_device, bg, zc):
    """decode(schedule="wire_auto") on a CUDA tensor decodes at Zc < 64,
    bit-equal to its plain twin on the CPU (per-codeblock early stop); the
    f32 mode and K2 keep the Zc >= 64 floor and raise."""
    _, llr = _noisy_llrs(bg, zc, 8, snr_db=2.0, seed=zc)
    q = torch.as_tensor(_wire(llr))
    hard, ok, _ = decoder_cuda.decode_layered_plain(q, bg, zc, wire=True,
                                                    early_stop=True)
    got = decoder.decode(q.to(cuda_device), bg, zc, schedule="wire_auto")
    assert torch.equal(got[0].cpu(), hard) and torch.equal(got[1].cpu(), ok)
    with pytest.raises(ValueError):
        decoder_cuda.decode_layered(torch.as_tensor(llr, device=cuda_device), bg,
                                    zc, wire=False)
    with pytest.raises(ValueError):
        decoder_cuda.decode_int8(torch.as_tensor(llr, device=cuda_device), bg, zc,
                                 b_tile=1)
