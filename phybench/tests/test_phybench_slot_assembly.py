"""The reader of ``slot_assembly_ms`` on a synthetic Chrome trace: device
milliseconds per step of the operations launched inside the program's
``phy.dl.slots`` and ``phy.ul.slots`` spans, None without a trace or where
the program opens neither span (a program without the TDD pattern), and
the ``air_slots`` line it prints on standard error where the measured
package has that counter."""

import pytest

from phybench import spec, stages
from phybench.run import Readings
from srsran_edgeric_5g_tpu_torch.utils import tracing

# Host ranges (name, start, end) and device operations (name, launch time
# on the host, device start, duration), in microseconds, one step.
PHY = [("phy.dl", 0, 50), ("phy.dl.ofdm", 1, 10), ("phy.dl.slots", 10, 20),
       ("phy.ul", 60, 100), ("phy.ul.slots", 61, 62), ("phy.ul.ofdm", 62, 70)]
OPS = [("fft_dl", 2, 100, 4), ("copy_dl", 11, 105, 3), ("fill_dl", 12, 108, 1),
       ("fft_ul", 63, 110, 2)]


def readings(phy=PHY) -> Readings:
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
          for n, a, b in phy]
    for corr, (name, launch, start, dur) in enumerate(OPS):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": launch, "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": start, "dur": dur,
                   "args": {"correlation": corr}})
    r = Readings(loop="batch", issue_s=[], trace=object())
    r.stages = stages.parse(ev, 1)
    return r


def test_it_reads_the_two_slot_spans():
    reader = spec.load_reader("slot_assembly_ms")
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == ("ms", "TDD slot assembly",
                                                         "x_real_time")
    tracing.air_slots.clear()
    tracing.air_slots.count("gnb_dl_slot_batch", "dl", 600)
    try:
        assert reader.read(readings()) == pytest.approx(0.004)
    finally:
        tracing.air_slots.clear()


def test_it_prints_the_air_slots_counter(capsys):
    tracing.air_slots.clear()
    tracing.air_slots.count("gnb_ul_slot_batch", "prach_span", 200)
    try:
        spec.load_reader("slot_assembly_ms").read(readings())
    finally:
        tracing.air_slots.clear()
    err = capsys.readouterr().err
    assert "# air_slots" in err and "'prach_span': 200" in err


def test_it_gives_nothing_without_a_trace_or_the_spans(monkeypatch, capsys):
    reader = spec.load_reader("slot_assembly_ms")
    assert reader.read(Readings(loop="batch", issue_s=[])) is None
    paired = [p for p in PHY if not p[0].endswith(".slots")]
    # A measured package without the counter (the parent of the pattern)
    # reads the same, and prints nothing.
    monkeypatch.delattr(tracing, "air_slots")
    assert reader.read(readings(paired)) is None
    assert "air_slots" not in capsys.readouterr().err
