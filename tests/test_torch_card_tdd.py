"""The 100 MHz n78 TDD carrier's shapes on the card (``-m cuda``; skipped on a
host without a CUDA device; no JAX): K1's wire decode at BG1 Zc 384 on the
cell's 3600 codeblocks a step, ``pdsch_encode`` / ``pdsch_modulate`` at its
TBS 23040 (Zc 352) and SSB-slot TBS, and ``pusch_demap`` over 273 PRB with
four 64-PRB UE spans, each against its plain version on the card; then the
full slot under the TDD pattern through the benchmark's chained step:
eager at its first call, captured once, replayed, its air slots and kernel
launches counted per step, bit for bit the eager bodies, and within the
configuration's limits of the frozen reference."""

import json

import pytest
import torch

from phybench import check
from phybench.chain import Chain, draw_inputs, full_cell_config
from phybench.spec import ROOT
from srsran_edgeric_5g_tpu_torch import cuda_build
from srsran_edgeric_5g_tpu_torch.ops import pdsch_code, pusch_front
from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder_cuda
from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm
from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as sp
from srsran_edgeric_5g_tpu_torch.parallel import step_graph as sg
from srsran_edgeric_5g_tpu_torch.utils import tracing
from test_torch_ldpc_kernel import _noisy_llrs, _wire
from test_torch_pdsch_code import _payload
from test_torch_pusch_front import _cell_front, _kernel_equals_plain, _record

CONFIG = json.loads((ROOT / "phybench/configs/nr100_n78_tdd_4ue.json").read_text())
FC = full_cell_config(fcm.FullCellConfig, CONFIG)
S = 20              # two TDD periods: two PRACH occasions over slots 7-8, 17-18
SEED = 2 ** 31 + 23
STEPS = 4


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_k1_wire_decode_at_zc_384_on_the_cells_codeblocks(cuda_device):
    """300 UL slots x 4 UEs x 3 codeblocks at BG1 Zc 384, K1's largest
    CTA: the kernel == its plain version, early stop and 6 fixed sweeps."""
    seg, _ = sp._plans(FC.ul_cell(), 0)
    assert (seg.bg, seg.zc, seg.c) == (1, 384, 3)
    _, llr = _noisy_llrs(1, 384, 3600, snr_db=1.5, seed=384)
    x = torch.as_tensor(_wire(llr), device=cuda_device)
    for early_stop in (True, False):
        before = cuda_build.LAUNCHES[decoder_cuda.KERNEL]
        got = decoder_cuda.decode_layered(x, 1, 384, num_iters=6, wire=True,
                                          early_stop=early_stop)
        assert cuda_build.LAUNCHES[decoder_cuda.KERNEL] == before + 1
        want = decoder_cuda.decode_layered_plain(x, 1, 384, num_iters=6, wire=True,
                                                 early_stop=early_stop)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [FC.dl_cell(), FC.dl_cell_ssb()], ids=["normal", "ssb"])
def test_pdsch_kernels_at_the_cells_tbs(cuda_device, cell):
    """64 PRB a UE: TBS 23040 in 3 codeblocks at Zc 352 on the normal
    slots, the SSB slots' shorter PDSCH; 64 TBs, each kernel once, bits
    and symbols equal to the plain chain's."""
    seg, rm = sp._plans(cell, 0)
    if cell.first_symbol == 2:
        assert (seg.a, seg.zc, seg.c) == (23040, 352, 3)
    pay = _payload(seg, 64, seed=seg.a)
    n = 64 * seg.c
    ref = pdsch_code.encode(torch.as_tensor(pay), seg, rm, slice(0, n))
    before = cuda_build.LAUNCHES[pdsch_code.KERNEL_ENCODE]
    bits = pdsch_code.encode(torch.as_tensor(pay, device=cuda_device), seg, rm,
                             slice(0, n))
    assert cuda_build.LAUNCHES[pdsch_code.KERNEL_ENCODE] == before + 1
    assert torch.equal(bits.cpu(), ref)
    rows = ref.reshape(64, -1)
    ci = sp._scrambling_inits(torch.as_tensor(FC.rntis()), cell, 64 // cell.nof_ue)
    want = pdsch_code.modulate(rows, ci, cell.modulation)
    before = cuda_build.LAUNCHES[pdsch_code.KERNEL_MODULATE]
    got = pdsch_code.modulate(rows.to(cuda_device), ci.to(cuda_device), cell.modulation)
    assert cuda_build.LAUNCHES[pdsch_code.KERNEL_MODULATE] == before + 1
    assert torch.equal(got.cpu().view(torch.float32), want.view(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2])
def test_pusch_demap_over_273_prb_with_four_64_prb_spans(cuda_device, seed, monkeypatch):
    """The cell's UL front on 300 slots (one step's UL slots) of its
    data-plane waveform: one launch, int8 LLRs equal to the plain chain's
    on the card."""
    cell = FC.ul_cell()
    assert (cell.nof_prb, cell.first_prb, cell.prb_per_ue, cell.nof_ue) == (273, 4, 64, 4)
    calls = _record(monkeypatch)
    before = cuda_build.LAUNCHES[pusch_front.KERNEL]
    _cell_front(FC, 300, seed, cuda_device)
    assert cuda_build.LAUNCHES[pusch_front.KERNEL] == before + 1
    _kernel_equals_plain(calls)


class _Eager(sg.StepGraphs):
    """Every call eager: the entry points' bodies as they are captured."""

    def mode(self, key) -> str:
        return "first_call"


def _steps(x, graphs) -> list:
    """STEPS chained steps of the benchmark's chain on fresh ``graphs``:
    per step (DL samples, UL results, how each call ran, the air slots and
    the kernel launches it counted)."""
    saved = fcm.STEP_GRAPHS
    fcm.STEP_GRAPHS = graphs
    try:
        ch = Chain(fcm, CONFIG, x, S, x["ul"].device)
        out = []
        for _ in range(STEPS):
            calls0, slots0 = tracing.graph_calls.snapshot(), tracing.air_slots.snapshot()
            launches0 = dict(cuda_build.LAUNCHES)
            res = ch()
            torch.cuda.synchronize()
            calls, slots = tracing.graph_calls.snapshot(), tracing.air_slots.snapshot()
            how = {e: [k for k, n in c.items() if n != calls0.get(e, {}).get(k, 0)]
                   for e, c in calls.items()}
            counted = {e: {k: n - slots0.get(e, {}).get(k, 0) for k, n in c.items()}
                       for e, c in slots.items()}
            launches = {k: n - launches0.get(k, 0) for k, n in cuda_build.LAUNCHES.items()}
            out.append((ch.td.clone(), {k: v.clone() for k, v in res.items()}, how,
                        counted, {k: n for k, n in launches.items() if n}))
        return out, ch
    finally:
        fcm.STEP_GRAPHS = saved


@pytest.fixture(scope="module")
def tdd_steps(cuda_device):
    x = draw_inputs(CONFIG, S, 25.0, SEED, cuda_device)
    graphed, ch = _steps(x, sg.StepGraphs())
    eager, _ = _steps(x, _Eager())
    ref_td, ref_res = check.reference_step(CONFIG, x, S, ch.last_flip(), cuda_device)
    numbers = check.compare(ch.td, ch.res, ref_td, ref_res, int(ch.bad))
    return dict(graphed=graphed, eager=eager, numbers=numbers)


@pytest.mark.cuda
def test_a_tdd_step_captures_once_and_then_replays(tdd_steps):
    assert [h["gnb_dl_slot_batch"] for _, _, h, _, _ in tdd_steps["graphed"]] == [
        ["first_call"], ["capture"], ["replay"], ["replay"]]
    # The first carry is none, the next ones strided views of the decoder
    # input: two keys, each eager once.
    assert [h["gnb_ul_slot_batch"] for _, _, h, _, _ in tdd_steps["graphed"]] == [
        ["first_call"], ["first_call"], ["capture"], ["replay"]]


@pytest.mark.cuda
def test_each_tdd_step_counts_its_air_slots_and_launches(tdd_steps):
    """Counted in the entry point, so a replay counts as an eager call:
    12 DL, 2 special and 6 silent slots down, 6 UL and 14 silent slots and
    two 2-slot PRACH windows up; one pusch_demap and one K1 launch per UL
    step, two of each PDSCH kernel per DL step."""
    want = {"gnb_dl_slot_batch": {"dl": 12, "special": 2, "silent": 6},
            "gnb_ul_slot_batch": {"ul": 6, "silent": 14, "prach_span": 4}}
    launches = tdd_steps["eager"][0][4]
    assert launches[pusch_front.KERNEL] == 1 and launches[decoder_cuda.KERNEL] == 1
    assert launches[pdsch_code.KERNEL_ENCODE] == launches[pdsch_code.KERNEL_MODULATE] == 2
    for run in ("graphed", "eager"):
        for _, _, _, counted, launched in tdd_steps[run]:
            assert counted == want
            assert launched == launches


@pytest.mark.cuda
def test_graphed_tdd_steps_equal_eager_ones_and_hold_to_the_reference(tdd_steps):
    for (td_g, res_g, *_), (td_e, res_e, *_) in zip(tdd_steps["graphed"],
                                                      tdd_steps["eager"]):
        assert torch.equal(td_g, td_e)
        assert res_g.keys() == res_e.keys()
        for k in res_e:
            assert torch.equal(res_g[k], res_e[k]), k
        assert bool(res_g["tb_ok"].all())
        assert [d.nonzero().flatten().tolist() for d in res_g["prach_detected"]] == [[7], [7]]
    assert check.judge(tdd_steps["numbers"], CONFIG["limits"]), tdd_steps["numbers"]
