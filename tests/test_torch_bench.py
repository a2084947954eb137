"""The port's benchmark and single-device entries against the root
``bench.py`` and ``__graft_entry__.py``, on the CPU.

  * Mode selection: for each argv, ``srsran_edgeric_5g_tpu_torch.bench.
    parse`` picks the function, arguments, full-cell overrides, iters and
    metric name that ``bench.py``'s ``main`` runs (its ``bench_*``
    functions recorded, not run).
  * Every mode runs on the CPU at S = 2 and one timed step, passes
    ``bench.py``'s asserts and prints its one JSON line.
  * The streaming loop keeps the chain: its carry after n batches is that
    of n + 1 plain chained steps.
  * ``entry()`` equals ``__graft_entry__.entry()`` jitted: bits exact,
    floats within 1e-4 of the peak.
  * Neither entry imports JAX.

On the card (``-m cuda``; they skip here) the streaming step makes no
synchronising call.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import bench as ref_bench
from srsran_edgeric_5g_tpu_torch import bench as tb
from srsran_edgeric_5g_tpu_torch import entry as te
from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
REF_FUNCTIONS = ("bench_full_cell", "bench_streaming", "bench_mimo",
                 "bench_full_cell_mimo", "bench_data_plane")
ARGVS = (
    [], ["--data-only"], ["--cells=4"], ["--cells=4", "--sbatch=64"],
    ["--mimo=2"], ["--mimo=4"], ["--mimo-full=2"], ["--qam256"],
    ["--qam256", "--chest=ls"], ["--mimo-full=2", "--qam256"], ["--no-csirs"],
    ["--clean"], ["--streaming=8"], ["--sbatch=16", "--iters=3"],
    ["--no-csirs", "--qam256", "--clean"], ["--streaming=16", "--clean"],
    ["--data-only", "--qam256"], ["--mimo=2", "--mimo-full=2", "--iters=5"],
)
# The modes a user runs (bench.py --mimo-full=2 --qam256 raises in the
# reference too: its 2-layer 256QAM TBS has unequal codeblock E).
RUN_ARGVS = (
    [], ["--data-only"], ["--cells=2"], ["--mimo=2"], ["--mimo=4"],
    ["--mimo-full=2"], ["--qam256"], ["--qam256", "--chest=ls"],
    ["--no-csirs"], ["--clean"],
)


def _reference_mode(monkeypatch, argv):
    """What ``bench.py``'s main runs for ``argv``: (function name, args,
    FC_KW, ITERS at the call, printed metric)."""
    calls = []

    def recorder(name):
        def record(*args):
            calls.append((name, args, dict(ref_bench.FC_KW), ref_bench.ITERS))
            return 1e-4, types.SimpleNamespace(cp=types.SimpleNamespace(total=23040)), ""
        return record

    for name in REF_FUNCTIONS:
        monkeypatch.setattr(ref_bench, name, recorder(name))
    monkeypatch.setattr(ref_bench, "FC_KW", {})
    monkeypatch.setattr(ref_bench, "ITERS", 30)
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        ref_bench.main()
    (name, args, fc_kw, iters), = calls
    return name, args, fc_kw, iters, json.loads(out.getvalue())["metric"]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "default")
def test_mode_selection_is_the_references(monkeypatch, argv):
    name, args, fc_kw, iters, metric = _reference_mode(monkeypatch, argv)
    mode = tb.parse(argv)
    assert mode.fn.__name__ == name
    assert mode.args == args
    assert mode.fc_kw == fc_kw
    assert mode.iters == iters
    assert mode.metric == metric
    assert mode.device == "cuda"
    assert tb.parse(argv + ["--device", "cpu"]).device == "cpu"


def test_fft_flag_is_refused():
    with pytest.raises(SystemExit) as exc:
        tb.main(["--fft=matmul"])
    assert exc.value.code not in (0, None)
    assert "set_fft_impl" in str(exc.value.code)


def test_a_cuda_device_is_required_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        tb.main(["--sbatch=2"])
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        te.entry()


@pytest.mark.parametrize("argv", RUN_ARGVS, ids=lambda a: " ".join(a) or "default")
def test_each_mode_runs(capsys, argv):
    """S = 2, one timed step: bench.py's asserts hold on the setup step,
    one JSON line with bench.py's keys on stdout, the timing on stderr."""
    args = argv + ["--sbatch=2", "--iters=1", "--device", "cpu"]
    assert tb.main(args) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == tb.parse(args).metric
    assert line["value"] > 0 and line["unit"] == tb.UNIT
    assert err.startswith("# chained timing, ") and "ms/slot" in err


def test_streaming_keeps_the_chain():
    """Three batches of S = 2, two deep: three latencies, and the carry
    after them is that of the setup step and three steps chained by hand
    (the last one with the noise sign flipped)."""
    fc = fcm.FullCellConfig()
    run = tb.stream(2, 25.0, depth=2, n_batches=3, compute_steps=1, device="cpu")
    assert run.latency_ms.shape == (3,) and (run.latency_ms > 0).all()
    assert np.isfinite(run.compute_ms) and run.x_real_time > 0
    assert run.desc().startswith("STREAMING full gNB slot, S=2 depth=2: sustained ")

    x = tb.full_cell_inputs(fc, 2, 25.0, "cpu")
    step = tb.full_cell_step(x, fc, 2, "cpu")
    eps = torch.zeros((), dtype=torch.int8)
    flip, soft = torch.ones(()), x["soft0"]
    for _ in range(4):
        res, eps, flip, _ = step(x["pay_n"], x["pay_s"], eps, flip, soft)
        soft = res["soft"]
    assert float(flip) == 1.0          # four flips: the last step used -1
    assert torch.equal(run.carry, soft)
    assert not torch.equal(soft, step(x["pay_n"], x["pay_s"], eps, flip,
                                      soft)[0]["soft"])


def test_inputs_are_bench_pys_draws():
    """The payloads and the channel are bench.py's default_rng(0) arrays."""
    fc = fcm.FullCellConfig()
    x = tb.full_cell_inputs(fc, 2, None, "cpu")
    rng = np.random.default_rng(0)
    for key, shape in (("pay_n", (1, 4, fc.dl_cell().derived_tbs())),
                       ("pay_s", (1, 4, fc.dl_cell_ssb().derived_tbs())),
                       ("dci", (2, 8, fc.dci_bits)), ("pbch", (1, 24)),
                       ("pay_u", (2, 4, fc.ul_cell().derived_tbs())),
                       ("ack", (2, 4, 2)), ("csi", (1, 4, fc.csi_bits))):
        np.testing.assert_array_equal(x[key].numpy(),
                                      rng.integers(0, 2, shape, dtype=np.int8))
    assert x["noise"] is None
    m = tb.mimo_inputs(2, 4, None, "cpu")
    rng = np.random.default_rng(0)
    rng.integers(0, 2, (2, 4, m["cell"].derived_tbs()), dtype=np.int8)
    a = (rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))) / np.sqrt(2)
    f = np.exp(-2j * np.pi * np.outer(np.arange(4), np.arange(4)) / 4)
    np.testing.assert_array_equal(m["mix"].numpy(),
                                  (0.35 * a + f / 2).astype(np.complex64))


def test_wire_floor_rule():
    """bench_mimo's rule at the 4x4 point: a TB that passes CRC must carry
    its payload; a TB that failed is counted, with the f32 decode of the same
    decoder input recovering every TB (here a failure forced onto a decoded
    TB: counted, and its CRC outcome unlike its codeblocks' parity)."""
    x = tb.mimo_inputs(1, 4, 25.0, "cpu")
    res, _, _, rx = tb.mimo_step(x, "cpu")(*tb._start(torch.device("cpu")))
    assert bool(res[1].all())
    assert tb.wire_floor(res, rx, x) == (0, 0)
    ok = res[1].clone()
    ok[0, 2] = False
    assert tb.wire_floor((res[0], ok), rx, x) == (1, 1)
    bad = res[0].clone()
    bad[0, 1, 5] ^= 1
    with pytest.raises(AssertionError, match="payload mismatch"):
        tb.wire_floor((bad, res[1]), rx, x)


def test_entry_is_the_references():
    """entry() on the CPU against __graft_entry__.entry() through jax.jit:
    payload, tb_ok and the carry exact, noise variance and CFO within 1e-4
    of the peak."""
    import jax
    fn, args = graft.entry()
    want = [np.asarray(v) for v in jax.jit(fn)(*args)]
    tfn, targs = te.entry("cpu")
    np.testing.assert_array_equal(targs[0].numpy(), np.asarray(args[0]))
    got = [v.numpy() for v in tfn(*targs)]
    for i in (0, 1, 4):
        np.testing.assert_array_equal(got[i], want[i])
    for i in (2, 3):
        np.testing.assert_allclose(got[i], want[i], rtol=0,
                                   atol=1e-4 * np.abs(want[i]).max())


def test_entries_import_no_jax():
    """A child with JAX and the JAX package blocked imports both entries."""
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', "
            "'srsran_edgeric_5g_tpu', 'bench', '__graft_entry__'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import srsran_edgeric_5g_tpu_torch.bench\n"
            "import srsran_edgeric_5g_tpu_torch.entry\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'srsran_edgeric_5g_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd="/",
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the decoder kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_streaming_step_makes_no_host_sync(cuda_device):
    """A warm streaming step (the full gNB slot, S = 8, the carry fed back)
    under set_sync_debug_mode("error"): no synchronising call."""
    chain = tb.FullCellChain(fcm.FullCellConfig(), 8, 25.0, cuda_device)
    tb.full_cell_asserts(chain(), chain.x)
    chain()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chain()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(chain.res["tb_ok"].all())


@pytest.mark.cuda
def test_entry_on_the_card_equals_the_cpu(cuda_device):
    fn, args = te.entry(cuda_device)
    got = [v.cpu() for v in fn(*args)]
    tfn, targs = te.entry("cpu")
    want = tfn(*targs)
    for i in (0, 1):
        assert torch.equal(got[i], want[i])
    for i in (2, 3):
        torch.testing.assert_close(got[i], want[i], rtol=0,
                                   atol=1e-4 * float(want[i].abs().max()))
