"""The full-slot entry points' CUDA graph (``parallel/step_graph.py``): the
rule that decides how a call runs, the key, the replay's copies and the
launch counts on the CPU with a stand-in for the graph; on the card
(``-m cuda``) graphed steps against eager ones."""

import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from srsran_edgeric_5g_tpu_torch import bench as tb, cuda_build
from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm, step_graph as sg
from srsran_edgeric_5g_tpu_torch.utils import tracing

S = 10      # one SSB period: SSB, CSI-RS, F2, SRS and PRACH occasions all in it


@pytest.mark.parametrize("seen, want", [
    ((True, False, False, False), "mesh"),
    ((False, True, False, False), "cpu"),
    ((False, False, True, False), "profiler"),
    ((False, False, False, True), "grad"),
    ((True, True, True, True), "mesh"),
    ((False, True, True, True), "cpu"),
    ((False, False, True, True), "profiler"),
    ((False, False, False, False), None),
], ids=["mesh", "cpu", "profiler", "grad", "all", "cpu_first", "profiler_first", "none"])
def test_eager_reason_names_the_first_cause(seen, want):
    assert sg.eager_reason(*seen) == want


def test_observe_reads_device_mesh_profiler_and_grad():
    cpu = torch.device("cpu")
    x, y = torch.zeros(3), torch.zeros(2, requires_grad=True)
    assert sg.observe((x, None), cpu, None) == (False, True, False, False)
    assert sg.observe((x,), cpu, object())[0]
    assert sg.observe((x, y), cpu, None)[3]
    # On a CUDA device: an input elsewhere, or no tensor, would be copied.
    cuda = torch.device("cuda", 0)
    assert not sg.observe((None,), cuda, None)[1]
    assert sg.observe((x,), cuda, None)[1]
    assert sg.observe(([0.0, 1.0],), cuda, None)[1]
    assert sg.observe((torch.zeros(3, device="meta"),), cuda, None)[1]
    with profile(activities=[ProfilerActivity.CPU]):
        assert sg.observe((x,), cpu, None)[2]
    assert not sg.observe((x,), cpu, None)[2]


class _Graph:
    """A stand-in for a CUDA graph: ``replay()`` runs ``run`` (the body's
    arithmetic, without its host bookkeeping) into the static outputs."""

    def __init__(self, run=None):
        self.run = run

    def replay(self):
        if self.run is not None:
            self.run()


@pytest.fixture
def no_card(monkeypatch):
    """``step_graph.capture`` on the CPU: the body's host code runs once, as
    in a capture, and the graph is a ``_Graph``; ``record.runs`` (a dict
    from the body to its arithmetic) gives the replay's work."""

    def record(fn, static_in):
        out = fn(*static_in)
        run = record.runs.get(fn)
        return _Graph(run and (lambda: run(static_in, out))), out

    record.runs = {}
    monkeypatch.setattr(sg, "_record", record)
    monkeypatch.setattr(cuda_build, "LAUNCHES", cuda_build.LAUNCHES.__class__())
    tracing.graph_calls.clear()
    tracing.builds.clear()
    yield record
    tracing.graph_calls.clear()
    tracing.builds.clear()


def test_the_first_call_of_a_key_runs_eager_then_it_captures_then_replays(no_card):
    g = sg.StepGraphs()
    seq = []
    for _ in range(4):
        seq.append(g.mode("k"))
        g.run("test.entry", "k", lambda: None, ())
    assert seq == ["first_call", "capture", "replay", "replay"]
    assert g.mode("other") == "first_call"


def test_the_oldest_graph_goes_past_the_limit(no_card, monkeypatch):
    monkeypatch.setattr(sg, "LIMIT", 2)
    g = sg.StepGraphs()
    for k in ("a", "b", "a", "b", "c", "c"):
        g.run("test.entry", k, lambda: None, ())
    assert [g.mode(k) for k in "abc"] == ["capture", "replay", "replay"]


def _fc_args():
    fc = fcm.FullCellConfig()
    rx = torch.zeros((S, 23040), dtype=torch.complex64)
    soft = torch.zeros((80, 15232), dtype=torch.int8)[:, 448:448 + 14784]
    return fc, rx, soft, torch.ones((S, 4))


def test_every_key_field_separates_keys():
    fc, rx, soft, ones = _fc_args()
    static = dict(fc=fc, s_total=S, num_iters=8, soft_flat=True, early_stop=True)
    cpu, meta = torch.device("cpu"), torch.device("meta")

    def key(entry="gnb_ul_slot_batch", dev=cpu, args=(rx, soft, ones), **kw):
        return sg.graph_key(entry, dev, args, **{**static, **kw})

    base = key()
    others = [
        key(entry="gnb_ul_slot_batch_mimo"),
        key(dev=meta),
        key(args=(rx[:5], soft, ones)),                              # shape
        key(args=(rx.to(torch.complex128), soft, ones)),             # dtype
        key(args=(rx, soft.contiguous(), ones)),                     # stride
        key(args=(rx.to(meta), soft, ones)),                         # device
        key(args=(rx, None, ones)),                                  # soft_in None
        key(args=(rx, soft, None)),                                  # new_data None
        key(fc=dataclasses.replace(fc, nof_prb=52)),
        key(s_total=20),
        key(num_iters=4),
        key(soft_flat=False),
        key(early_stop=False),
    ]
    assert len({base, *others}) == 1 + len(others)
    # The values of the inputs are no part of it.
    assert key(args=(torch.ones_like(rx), soft, ones * 2)) == base


def test_a_buffer_keeps_the_strides_where_no_two_elements_overlap():
    _, _, soft, _ = _fc_args()
    assert sg._empty_like(soft).stride() == soft.stride()
    wide = torch.zeros(3, 1).expand(3, 5)
    assert sg._empty_like(wide).is_contiguous()
    soft = torch.randint(-127, 128, soft.shape, dtype=torch.int8)[:, :14000]
    out = sg._fresh({"a": soft, "b": wide, "n": 1})
    assert out["a"].stride() == soft.stride() and out["n"] == 1
    assert torch.equal(out["a"], soft) and torch.equal(out["b"], wide)
    # Into a buffer of the same layout, the gaps too; elsewhere element-wise.
    into = sg._empty_like(soft)
    assert torch.equal(sg._copy(into, soft), soft)
    assert torch.equal(sg._copy(torch.empty(soft.shape, dtype=torch.int8), soft), soft)


def test_a_replay_copies_its_inputs_in_and_its_outputs_out(no_card):
    """Fresh outputs every call, laid out as the body's, and each replay's
    launches those the capture counted."""

    def arith(a, b):
        return torch.cat([b, a * 2 + b], dim=1)

    def body(a, b):
        cuda_build.LAUNCHES["test_kernel"] += 1
        return {"y": arith(a, b)[:, 1:], "n": 7}

    no_card.runs[body] = lambda static_in, out: out["y"].copy_(arith(*static_in)[:, 1:])
    g = sg.StepGraphs()
    outs, counts = [], []
    for i in range(4):
        a, b = torch.full((2, 3), float(i)), torch.full((2, 1), float(-i))
        before = cuda_build.LAUNCHES["test_kernel"]
        outs.append((i, g.run("test.entry", "k", body, (a, b))))
        counts.append(cuda_build.LAUNCHES["test_kernel"] - before)
    assert counts == [1, 1, 1, 1]
    for i, out in outs:          # no call wrote what an earlier one returned
        assert torch.equal(out["y"], torch.full((2, 3), float(i)))
        assert out["y"].stride() == (4, 1) and out["n"] == 7
    assert tracing.graph_calls.snapshot() == {
        "test.entry": {"first_call": 1, "capture": 1, "replay": 2}}
    assert tracing.builds.snapshot()["graph.test.entry"][0] == 1


def test_calls_off_the_card_run_eager_by_reason(no_card, monkeypatch):
    monkeypatch.setattr(sg, "_record", lambda fn, static_in: pytest.fail("captured"))
    g = sg.StepGraphs()
    x = torch.ones(3)
    for _ in range(3):
        assert g("test.entry", lambda a: a + 1, (x,), "cpu", None)[0] == 2
    assert g("test.entry", lambda a: a + 2, (x,), "cpu", object())[0] == 3
    assert tracing.graph_calls.snapshot() == {"test.entry": {"cpu": 3, "mesh": 1}}


def test_a_full_slot_call_on_the_cpu_counts_as_eager():
    torch.set_num_threads(2)
    fc = fcm.FullCellConfig()
    x = tb.full_cell_inputs(fc, S, 25.0, "cpu")
    tracing.graph_calls.clear()
    x["gnb_dl"](x["pay_n"], x["pay_s"], x["dci"], x["pbch"], fc, S, device="cpu")
    assert tracing.graph_calls.snapshot() == {"gnb_dl_slot_batch": {"cpu": 1}}
    tracing.graph_calls.clear()


# ------------------------------------------------------------------ on the card

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _chain(x, fc, dl, ul, steps: int):
    """bench.py's chained step over ``dl`` / ``ul``: per step (td, res,
    how each call ran, the kernel launches it counted)."""
    out, soft, eps, flip = [], x["soft0"], *tb._start(x["ones"].device)
    for _ in range(steps):
        calls0, launches0 = tracing.graph_calls.snapshot(), dict(cuda_build.LAUNCHES)
        td = dl(x["pay_n"] ^ eps, x["pay_s"], x["dci"], x["pbch"], fc, S,
                device=x["ones"].device)
        res = ul(x["ul"] + x["noise"] * flip, fc, S, soft_in=soft, new_data=x["ones"],
                 soft_flat=True, device=x["ones"].device)
        eps = (res["payload"][0, 0, 0] & 0) | ((td.real ** 2).mean() > 1e30).to(torch.int8)
        soft, flip = res["soft"], -flip
        calls = tracing.graph_calls.snapshot()
        how = {e: [k for k, n in c.items() if n != calls0.get(e, {}).get(k, 0)]
               for e, c in calls.items()}
        launches = {k: n - launches0.get(k, 0) for k, n in cuda_build.LAUNCHES.items()}
        out.append((td, res, how, {k: n for k, n in launches.items() if n}))
    return out


@pytest.fixture(scope="module", params=[1, 2], ids=["siso", "mimo2x2"])
def chains(request, cuda_device):
    """Four chained steps graphed (a fresh ``StepGraphs``) and four eager
    (the entry points' bodies), from the same inputs."""
    fc = fcm.FullCellConfig(n_layers=request.param)
    x = tb.full_cell_inputs(fc, S, 25.0, cuda_device)
    mimo = fc.n_layers > 1
    saved = fcm.STEP_GRAPHS
    fcm.STEP_GRAPHS = sg.StepGraphs()
    try:
        graphed = _chain(x, fc, x["gnb_dl"], x["gnb_ul"], 4)
    finally:
        fcm.STEP_GRAPHS = saved
    body_dl = fcm._dl_slot_batch_mimo if mimo else fcm._dl_slot_batch
    body_ul = fcm._ul_slot_batch_mimo if mimo else fcm._ul_slot_batch

    def dl(pn, ps, dci, pbch, fc, s, device):
        return body_dl(pn, ps, dci, pbch, fc, s, device, None)

    def ul(rx, fc, s, soft_in, new_data, soft_flat, device):
        return body_ul(rx, soft_in, new_data, fc, s, fcm.decoder.DEFAULT_ITERS, soft_flat,
                       True, device, None)

    torch.cuda.synchronize()
    eager = _chain(x, fc, dl, ul, 4)
    torch.cuda.synchronize()
    return dict(fc=fc, x=x, graphed=graphed, eager=eager, mimo=mimo)


@pytest.mark.cuda
def test_the_steps_run_eager_capture_and_replay(chains):
    suffix = "_mimo" if chains["mimo"] else ""
    dl, ul = f"gnb_dl_slot_batch{suffix}", f"gnb_ul_slot_batch{suffix}"
    assert [h[dl] for _, _, h, _ in chains["graphed"]] == [
        ["first_call"], ["capture"], ["replay"], ["replay"]]
    # The first carry is bench.py's contiguous zeros, the next ones strided
    # views of the decoder input: two keys, each eager once.
    assert [h[ul] for _, _, h, _ in chains["graphed"]] == [
        ["first_call"], ["first_call"], ["capture"], ["replay"]]


@pytest.mark.cuda
def test_graphed_steps_equal_eager_ones_bit_for_bit(chains):
    """Compared after all four steps, so each step's tensors also held
    through the later calls."""
    for (td_g, res_g, _, _), (td_e, res_e, _, _) in zip(chains["graphed"], chains["eager"]):
        assert torch.equal(td_g, td_e)
        assert res_g.keys() == res_e.keys()
        for k in res_e:
            assert res_g[k].dtype == res_e[k].dtype and res_g[k].stride() == res_e[k].stride()
            assert torch.equal(res_g[k], res_e[k]), k
    assert bool(chains["graphed"][-1][1]["tb_ok"].all())


@pytest.mark.cuda
def test_a_returned_step_holds_through_two_more_calls(chains, monkeypatch):
    fc, x = chains["fc"], chains["x"]
    dl, ul = x["gnb_dl"], x["gnb_ul"]
    dev = x["ones"].device
    monkeypatch.setattr(fcm, "STEP_GRAPHS", sg.StepGraphs())

    def step(eps, flip, soft):
        td = dl(x["pay_n"] ^ eps, x["pay_s"], x["dci"], x["pbch"], fc, S, device=dev)
        res = ul(x["ul"] + x["noise"] * flip, fc, S, soft_in=soft, new_data=x["ones"],
                 soft_flat=True, device=dev)
        return td, res

    soft = chains["graphed"][-1][1]["soft"]
    for _ in range(2):              # each key's first call, then its capture
        soft = step(0, 1.0, soft)[1]["soft"]
    before = tracing.graph_calls.snapshot()
    td1, res1 = step(0, 1.0, soft)
    keep = (td1.clone(), {k: v.clone() for k, v in res1.items()})
    for _ in range(2):
        step(1, -1.0, res1["soft"])
    torch.cuda.synchronize()
    after = tracing.graph_calls.snapshot()
    for e in (dl.__name__, ul.__name__):
        assert after[e]["replay"] - before[e].get("replay", 0) == 3
    assert torch.equal(td1, keep[0])
    assert all(torch.equal(res1[k], keep[1][k]) for k in res1)


@pytest.mark.cuda
def test_a_replay_counts_the_launches_of_an_eager_step(chains):
    eager = chains["eager"][0][3]
    assert eager.get("pusch_demap") == 1 and eager.get("pdsch_encode") == 2
    assert all(launches == eager for _, _, _, launches in chains["graphed"])
    assert all(launches == eager for _, _, _, launches in chains["eager"])


@pytest.mark.cuda
def test_a_profiled_call_runs_eager_with_its_stage_spans(chains, tmp_path):
    fc, x = chains["fc"], chains["x"]
    soft = chains["graphed"][-1][1]["soft"]
    gnb_ul = x["gnb_ul"]
    name = gnb_ul.__name__
    for _ in range(3):       # the module's graphs: this key captured, then replayed
        gnb_ul(x["ul"], fc, S, soft_in=soft, new_data=x["ones"], soft_flat=True,
               device=soft.device)
    before = tracing.graph_calls.snapshot()[name]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gnb_ul(x["ul"], fc, S, soft_in=soft, new_data=x["ones"], soft_flat=True,
               device=soft.device)
        torch.cuda.synchronize()
    after = tracing.graph_calls.snapshot()[name]
    assert after.get("profiler", 0) == before.get("profiler", 0) + 1
    assert {k: v for k, v in after.items() if k != "profiler"} == \
        {k: v for k, v in before.items() if k != "profiler"}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("phy.ul")]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]

    def under(e, span):
        t = launch.get(e["args"].get("correlation"))
        return t is not None and any(n == span and a <= t <= b for n, a, b in spans)

    assert len(kernels) > 50
    assert any(under(e, "phy.ul.decode") and "layered" in e["name"] for e in kernels)
    assert any(under(e, "phy.ul.front") and "pusch_demap" in e["name"] for e in kernels)
    assert sum(under(e, "phy.ul") for e in kernels) == len(kernels)
