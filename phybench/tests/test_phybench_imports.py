"""Nothing the harness or its reference loads is JAX or the JAX package,
compared by whole top-level names (the measured package's name begins
with the JAX package's), and the reference loads nothing of the measured
package."""

import subprocess
import sys

from phybench import run
from phybench.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "srsran_edgeric_5g_tpu"}
PORT = "srsran_edgeric_5g_tpu_torch"


def _top_level_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_harness_and_reference_load_neither_jax_nor_the_port():
    mods = _top_level_after(
        "import phybench.run, phybench.check, phybench.chain, phybench.loops, "
        "phybench.spec, phybench.trace, phybench.calibrate, phybench.sweep_stream\n"
        "import phybench.reference.parallel.full_cell, phybench.reference.control, "
        "phybench.reference.inputs\n"
        "from phybench.spec import HERE, load_reader\n"
        "[load_reader(f.stem) for f in (HERE / 'metrics').glob('*.py') if f.stem != '__init__']")
    assert not mods & FORBIDDEN
    assert PORT not in mods


def test_the_measured_package_loads_no_jax():
    mods = _top_level_after(
        "import phybench.run\n"
        "import srsran_edgeric_5g_tpu_torch.parallel.full_cell\n"
        "import srsran_edgeric_5g_tpu_torch.cuda_build")
    assert PORT in mods and not mods & FORBIDDEN


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setattr(sys, "modules", {PORT: object(), PORT + ".ops": object(),
                                         "jaxtyping": object(), "os": object()})
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "srsran_edgeric_5g_tpu", object())
    assert run.forbidden_modules() == ["jaxlib", "srsran_edgeric_5g_tpu"]
