"""The stage readers on a synthetic Chrome trace: the program's ``phy.*``
ranges leave every existing metric, label and breakdown entry as it was,
each new reader reads its number (None with no trace), and a gap is late
when the operation ending it was launched after it began.  Then the stage
capture on the measured package's plain path, at a tiny size on the CPU."""

import pytest
import torch

from phybench import spec, stages, trace
from phybench.run import Readings

BENCH = spec.load_benchmark()
OLD = ["device_ops_per_step", "dl_device_ms", "ul_device_ms", "decode_roofline",
       "idle_share"]
NEW = ["setup_build_s", "dl_code_ms", "dl_control_ms", "dl_grid_ms", "ofdm_ms",
       "ul_front_ms", "ul_dematch_ms", "ul_decode_ms", "ul_control_ms", "host_own_ms",
       "idle_host_ms"]

# Host ranges (name, start, end), in microseconds on the trace's clock.
HARNESS = [("step", 0, 100), ("gnb_dl", 1, 40), ("gnb_ul", 45, 95),
           ("step", 139, 170), ("gnb_dl", 139.5, 161)]
PHY = [("phy.dl", 2, 39), ("phy.dl.code", 3, 10), ("phy.dl.control", 10, 15),
       ("phy.dl.grid", 15, 25), ("phy.dl.ofdm", 25, 36),
       ("phy.ul", 46, 94), ("phy.ul.ofdm", 47, 50), ("phy.ul.front", 50, 60),
       ("phy.ul.dematch", 60, 65), ("phy.ul.decode", 65, 80),
       ("phy.ul.control", 80, 93), ("phy.ul.control.prach", 85, 92),
       ("phy.dl", 140, 160), ("phy.dl.code", 141, 158)]
# Device operations: (name, launch time on the host, device start, duration).
OPS = [("gemm_code", 4, 100, 10), ("polar_k", 11, 110, 2), ("grid_k", 16, 112, 3),
       ("fft_dl", 26, 115, 4), ("glue_dl", 37, 119, 1),
       ("fft_ul", 48, 121, 3),          # a 1 us gap before it, launched long before
       ("front_k", 55, 124, 6), ("dematch_k", 61, 130, 2),
       ("void (anonymous namespace)::layered_kernel<1>(int)", 66, 132, 8),
       ("crc_k", 70, 140, 1), ("prach_k", 86, 141, 2), ("step_glue", 96, 143, 1),
       ("late_k", 150, 152, 1)]         # an 8 us gap before it, launched in it
WALL_S = 200e-6


def events(with_phy: bool = True) -> list[dict]:
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
          for n, a, b in HARNESS + (PHY if with_phy else [])]
    for corr, (name, launch, start, dur) in enumerate(OPS):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": launch, "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": start, "dur": dur,
                   "args": {"correlation": corr}})
    return ev


# The program's tracer events of the unprofiled pass (its own clock).
TRACER = [{"name": n, "ph": "X", "ts": a, "dur": b - a, "args": {}}
          for n, a, b in PHY]


def readings(with_phy: bool = True) -> Readings:
    r = Readings(loop="batch", issue_s=[], trace=trace.parse(events(with_phy), 1, WALL_S),
                 unprofiled_wall_s=WALL_S, decode_bound_s=2e-6)
    r.stages = stages.parse(events(with_phy), 1)
    r.stages.host_own = stages.host_own_ms(TRACER if with_phy else [], 1)
    r.builds = {"parallel.full_cell._f1_static": (1, 0.5), "nvcc.ldpc_layered": (1, 0.25)}
    return r


def test_the_program_spans_leave_the_existing_readings_as_they_were():
    a, b = readings(True), readings(False)
    assert a.trace.ops == b.trace.ops and a.trace.ranges == b.trace.ranges
    assert [o.label for o in a.trace.ops] == ["gnb_dl"] * 5 + ["gnb_ul"] * 6 + [
        "glue", "gnb_dl"]
    assert a.trace.top_ops(10) == b.trace.top_ops(10)
    assert a.trace.idle_gaps(10) == b.trace.idle_gaps(10) == [
        ["before gnb_dl: late_k", 8e-6], ["before gnb_ul: fft_ul", 1e-6]]
    for m in OLD:
        reader = spec.load_reader(m)
        assert reader.read(a) == reader.read(b) is not None, m
    assert spec.load_reader("dl_device_ms").read(a) == pytest.approx(0.021)


def test_each_new_reader_reads_its_stage():
    r = readings()
    want = {"setup_build_s": 0.5, "dl_code_ms": 0.011, "dl_control_ms": 0.002,
            "dl_grid_ms": 0.003, "ofdm_ms": 0.007, "ul_front_ms": 0.006,
            "ul_dematch_ms": 0.002, "ul_decode_ms": 0.009, "ul_control_ms": 0.002,
            # 37 + 48 + 20 us inside the tracer's phy.dl / phy.ul events
            "host_own_ms": 0.105, "idle_host_ms": 0.008}
    assert set(want) == set(NEW) == {m["name"] for m in BENCH["per_layer"]} - set(OLD)
    for m, v in want.items():
        assert spec.load_reader(m).read(r) == pytest.approx(v), m
    st = r.stages
    assert st.own_ms("phy.dl") == pytest.approx(0.001)     # glue_dl: no stage
    assert st.own_ms("phy.ul") == 0
    assert st.idle_ms() == pytest.approx(0.009)
    assert "['phy.ul.decode']" in stages.k1_line(st)


@pytest.mark.parametrize("metric", NEW)
def test_a_new_reader_gives_nothing_without_a_trace(metric):
    reader = spec.load_reader(metric)
    assert reader.read(Readings(loop="batch", issue_s=[])) is None
    # A traced run that is not ``python3 -m phybench.run`` has no capture.
    r = readings()
    del r.stages, r.builds
    assert reader.read(r) is None


def test_setup_build_s_leaves_out_nvcc():
    """nvcc runs only in a checkout's first run; the builders' seconds stay."""
    r = readings()
    r.builds.update({"nvcc.other": (1, 9.0)})
    assert spec.load_reader("setup_build_s").read(r) == pytest.approx(0.5)
    assert "nvcc.other: 9.0 1" in stages.build_lines(r.builds)


def test_a_gap_is_late_when_its_op_was_launched_after_it_began():
    gaps = readings().stages.gaps
    assert [(g.dur_us, g.late, g.host_span, g.next_op) for g in gaps] == [
        (1, False, "", "fft_ul"), (8, True, "phy.dl.code", "late_k")]
    text = "\n".join(readings().stages.lines())
    assert "#   0.008 phy.dl.code late late_k" in text
    assert "#   0.001 - queued fft_ul" in text


def test_the_capture_finds_every_stage_of_the_plain_path():
    """Two profiled steps of the SISO cell at 10 slots on the CPU: every
    span, host time in each, no device operation (the CPU has none)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell = spec.load_cell("nr20_siso_batch1024")
        cell.traffic = dict(cell.traffic, slots=10, warmup_steps=1, profile_steps=2)
        st = stages.measure(cell, 2 ** 31 + 5, torch.device("cpu"))
    finally:
        torch.set_num_threads(n)
    names = {n for n, _, _ in st.spans}
    assert {"phy.dl", "phy.dl.code", "phy.dl.control", "phy.dl.grid", "phy.dl.ofdm",
            "phy.ul", "phy.ul.ofdm", "phy.ul.front", "phy.ul.dematch", "phy.ul.decode",
            "phy.ul.control"} <= names
    assert st.host_own > 0 and not st.ops and st.device_ms("phy.dl") is None
    assert "plain" in st.notes["on-cost, wall s of the same steps"]
