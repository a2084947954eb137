"""The check that decides ``correct``, at a small size on the CPU: the
measured package's plain path passes it, its control (the reference in
bfloat16) fails it, and a run with the timed path broken underneath comes
out not correct, for each fault the cells can have.  The run's own
readings on the card at the cells' sizes are in PERF.md."""

import json

import pytest
import torch

from phybench import check, run
from phybench.chain import Chain, draw_inputs
from phybench.spec import HERE, load_benchmark, load_cell

S = 10          # every occasion (SSB, CSI, CSI-RS, SRS, PRACH) once
SEED = 2 ** 31 + 77
CELLS = [w["name"] for w in load_benchmark()["workloads"]]


def with_stream_cell() -> dict:
    """BENCHMARK.json with the open-loop stream cell's entries
    (``stream_cell.json``), which the benchmark leaves out while its runs
    spread too widely for a bound."""
    bench = load_benchmark()
    extra = json.loads((HERE / "tests" / "stream_cell.json").read_text())
    for group, entries in extra.items():
        bench[group] = bench[group] + entries
    return bench


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(cell):
    from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm

    c = load_cell(cell)
    dev = torch.device("cpu")
    x = draw_inputs(c.config, S, c.traffic["snr_db"], SEED, dev)
    ch = Chain(fcm, c.config, x, S, dev)
    for _ in range(2):
        ch()
    ref_td, ref_res = check.reference_step(c.config, x, S, ch.last_flip(), dev)
    nums = check.compare(ch.td, ch.res, ref_td, ref_res, int(ch.bad))
    assert check.judge(nums, c.config["limits"]), nums
    low_td, low_res = check.reference_step(c.config, x, S, ch.last_flip(), dev, lower=True)
    ctl = check.compare(low_td, low_res, ref_td, ref_res, 0)
    assert not check.judge(ctl, c.config["limits"]), ctl
    assert ctl["dl_err"] > c.config["limits"]["dl_err"]


def _state_unchanged(fcm):
    real = fcm.gnb_ul_slot_batch

    def ul(rx, fc, s, soft_in=None, **kw):
        res = real(rx, fc, s, soft_in=soft_in, **kw)
        if soft_in is not None:
            res["soft"] = soft_in
        return res
    fcm.gnb_ul_slot_batch = ul


def _half_the_batch(fcm):
    real = fcm.gnb_ul_slot_batch

    def ul(rx, fc, s, **kw):
        rx = rx.clone()
        rx[s // 2:] = 0
        return real(rx, fc, s, **kw)
    fcm.gnb_ul_slot_batch = ul


def _answer_altered(fcm):
    real = fcm.gnb_ul_slot_batch

    def ul(*a, **kw):
        res = real(*a, **kw)
        res["payload"][0, 0, 0] ^= 1
        return res
    fcm.gnb_ul_slot_batch = ul


def _dl_half_left_out(fcm):
    real = fcm.gnb_dl_slot_batch

    def dl(*a, **kw):
        td = real(*a, **kw)
        td[td.shape[0] // 2:] = 0
        return td
    fcm.gnb_dl_slot_batch = dl


@pytest.mark.parametrize("cell", CELLS + ["nr20_siso_stream"])
def test_sound_run_is_correct(cell):
    out, _, lines = run.rehearse(cell, SEED, seconds=0.03, trace=True,
                                 bench=with_stream_cell())
    assert out["correct"], lines
    assert list(out)[-1] == "check" and set(out["check"]) == set(check.NAMES)
    assert out["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _answer_altered,
                                   _dl_half_left_out])
def test_a_broken_timed_path_is_not_correct(fault):
    out, _, lines = run.rehearse(CELLS[0], SEED, seconds=0.03, patch=fault)
    assert not out["correct"], lines
