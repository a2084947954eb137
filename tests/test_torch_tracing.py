"""The port's tracer on the profiler's clock, the full slot's stage spans and
the build counter (CPU, tiny S)."""

import json
import subprocess
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from srsran_edgeric_5g_tpu_torch import bench as tb, cuda_build
from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm
from srsran_edgeric_5g_tpu_torch.utils import tracing

S = 10      # one SSB period: every control occasion once
STAGES = {"phy.dl.code", "phy.dl.control", "phy.dl.grid", "phy.dl.ofdm",
          "phy.ul.ofdm", "phy.ul.front", "phy.ul.dematch", "phy.ul.decode",
          "phy.ul.control"}
CONTROL = {"phy.ul.control.pucch_f1", "phy.ul.control.pucch_f2",
           "phy.ul.control.srs", "phy.ul.control.prach"}


def _events(prof, tmp_path) -> dict:
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def _annotations(doc: dict) -> list[dict]:
    return [e for e in doc["traceEvents"] if e.get("cat") == "user_annotation"]


def test_a_span_is_a_profiler_range(tmp_path):
    tr = tracing.EventTracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("phy.test"):
            torch.ones(64).sum()
    names = [e["name"] for e in _annotations(_events(prof, tmp_path))]
    assert names == ["phy.test"]
    assert not tr._events        # the tracer itself is off


def test_tracer_and_profiler_share_the_epoch_clock(tmp_path):
    tr = tracing.EventTracer()
    tr.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.002)
        with tr.span("phy.test", slot=3):
            torch.ones(64).sum()
    tr.write(str(tmp_path / "tracer.json"))
    mine = json.loads((tmp_path / "tracer.json").read_text())
    theirs = _events(prof, tmp_path)
    (ev,) = mine["traceEvents"]
    (ann,) = _annotations(theirs)
    assert (ev["name"], ev["ph"], ev["args"]) == ("phy.test", "X", {"slot": 3})
    mine_ns = mine["baseTimeNanoseconds"] + ev["ts"] * 1e3
    theirs_ns = theirs["baseTimeNanoseconds"] + ann["ts"] * 1e3
    assert abs(mine_ns - theirs_ns) < 10e6


def test_a_span_with_nothing_on_records_nothing(monkeypatch):
    def never(name):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(tracing, "record_function", never)
    tr = tracing.EventTracer()
    assert tr.span("phy.test") is tr.span("phy.other", slot=1)
    with tr.span("phy.test"):
        pass
    tr.instant("phy.instant")
    assert not tr._events


@pytest.mark.parametrize("n_layers", [1, 2])
def test_full_slot_opens_every_stage_span(n_layers, tmp_path):
    """Each entry point opens every stage span under its direction's span;
    nearly all of the host's op time inside phy.dl / phy.ul lies in a stage;
    the outputs are bit-identical with the profiler on and off."""
    torch.set_num_threads(2)
    fc = fcm.FullCellConfig(n_layers=n_layers)
    x = tb.full_cell_inputs(fc, S, 25.0, "cpu")

    def run():
        td = x["gnb_dl"](x["pay_n"], x["pay_s"], x["dci"], x["pbch"], fc, S,
                         device="cpu")
        res = x["gnb_ul"](x["ul"] + x["noise"], fc, S, soft_in=x["soft0"],
                          new_data=x["ones"], soft_flat=True, device="cpu")
        return td, res

    td0, res0 = run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        td1, res1 = run()
    assert torch.equal(td0, td1)
    assert res0.keys() == res1.keys()
    assert all(torch.equal(res0[k], res1[k]) for k in res0)

    events = _events(prof, tmp_path)["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("phy.")]
    assert {n for n, _, _ in spans} == {"phy.dl", "phy.ul"} | STAGES | CONTROL
    tops = [s for s in spans if s[0] in ("phy.dl", "phy.ul")]
    stages = [s for s in spans if s[0] in STAGES]
    for name, a, b in stages:
        top = "phy." + name.split(".")[1]
        assert any(n == top and a0 <= a and b <= b0 for n, a0, b0 in tops), name

    # The outermost ops (none nested in another), by their host time.
    ops = sorted(((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "cpu_op"), key=lambda o: (o[0], -o[1]))
    outer, end = [], float("-inf")
    for a, b in ops:
        if a >= end:
            outer.append((a, b))
            end = b

    def inside(op, among):
        return any(a <= op[0] and op[1] <= b for _, a, b in among)

    in_top = [o for o in outer if inside(o, tops)]
    total = sum(b - a for a, b in in_top)
    staged = sum(b - a for a, b in in_top if inside((a, b), stages))
    assert total > 0 and staged >= 0.9 * total


def test_cached_build_counts_each_miss_and_its_own_seconds():
    tracing.builds.clear()

    @tracing.cached_build
    def inner(k):
        time.sleep(0.05)
        return k

    @tracing.cached_build
    def outer(k):
        time.sleep(0.005)
        return inner(k) + 1

    t0 = time.perf_counter()
    assert [outer(1), outer(1), outer(2), inner(2)] == [2, 2, 3, 2]
    wall = time.perf_counter() - t0
    got = tracing.builds.snapshot()
    name = (__name__.split(".", 1)[-1]
            + ".test_cached_build_counts_each_miss_and_its_own_seconds.<locals>.")
    assert {k: m for k, (m, _) in got.items()} == {name + "outer": 2, name + "inner": 2}
    assert got[name + "inner"][1] >= 0.1
    assert sum(s for _, s in got.values()) <= wall
    # Exclusive: outer's seconds leave out the 0.1 s of inner's misses.
    assert got[name + "outer"][1] < 0.05
    assert outer.cache_info().misses == 2 and outer.cache_info().hits == 1
    outer.cache_clear()
    assert outer.cache_info().currsize == 0
    assert outer(1) == 2 and tracing.builds.snapshot()[name + "outer"][0] == 3
    tracing.builds.clear()


def test_the_cuda_build_counts_nvcc_only_when_it_runs(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")

    def fake_nvcc(cmd, **kw):
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(cuda_build.subprocess, "run", fake_nvcc)
    tracing.builds.clear()
    cuda_build.build("ldpc_layered")
    cuda_build.build("ldpc_layered")      # the library is there: no nvcc
    (misses, seconds), = [v for k, v in tracing.builds.snapshot().items()
                          if k == "nvcc.ldpc_layered"]
    assert misses == 1 and seconds >= 0
    assert list(tracing.builds.snapshot()) == ["nvcc.ldpc_layered"]
    tracing.builds.clear()
