"""The run command on the card: one short traced run of a cell prints a
correct result line.  Skips where there is no CUDA device."""

import json
import subprocess
import sys

import pytest

from phybench.spec import ROOT


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device")


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "phybench.run", "--workload",
                          "nr20_mimo2x2_batch512", "--seed", "4294967311", "--seconds", "2",
                          "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0 and "idle_share" in res["metrics"]
    assert out.stderr.strip().splitlines()[-1].startswith("check tb_fail")


def test_the_command_refuses_a_host_without_a_card(monkeypatch):
    import torch

    from phybench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "nr20_mimo2x2_batch512", "--seed", "1", "--seconds", "1"]) == 2
