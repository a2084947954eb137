"""The device trace of a profiled sub-window, reduced to what the per-layer
metrics read: each device operation with its start, duration and the host
range under which it was launched, the union of the busy intervals, and the
idle gaps labelled by what the host was doing.

The trace is torch.profiler's (CUPTI) Chrome trace.  A device operation
(a kernel, a copy or a memset) carries the correlation id of the runtime
call that launched it; that call's host timestamp places the launch inside
the harness's ``record_function`` ranges, the innermost of which labels
the operation.  Host and device timestamps share one clock in microseconds.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The harness's own host ranges, innermost first when nested.
RANGES = ("gnb_dl", "gnb_ul", "step", "batch")


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    label: str          # the innermost harness range of its launch, or "other"

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


@dataclasses.dataclass
class Trace:
    ops: list[DeviceOp]
    ranges: list[tuple[str, float, float]]   # (name, start_us, end_us) on the host
    steps: int                               # steps (or batches) in the sub-window
    wall_s: float                            # the sub-window's host wall, profiled

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        return sum(b - a for a, b in union(self.ops)) * 1e-6

    def device_s(self, pred) -> float:
        """Summed duration of the operations for which ``pred(op)`` holds."""
        return sum(o.dur_us for o in self.ops if pred(o)) * 1e-6

    def top_ops(self, n: int = 10) -> list[list]:
        """The ``n`` operation names with the most device time, in seconds."""
        tot: dict[str, float] = {}
        for o in self.ops:
            tot[o.name] = tot.get(o.name, 0.0) + o.dur_us * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The ``n`` longest gaps between busy intervals, each named by the
        host range that launched the operation ending the gap (what the
        device waited for), in seconds."""
        ops = sorted(self.ops, key=lambda o: o.start_us)
        gaps, end = [], None
        for o in ops:
            if end is not None and o.start_us > end:
                gaps.append([f"before {o.label}: {short(o.name)}",
                             (o.start_us - end) * 1e-6])
            end = o.end_us if end is None else max(end, o.end_us)
        return sorted(gaps, key=lambda g: -g[1])[:n]


def short(name: str, n: int = 60) -> str:
    """A kernel's name without its template arguments and signature."""
    for cut in ("(", "<"):
        i = name.find(cut)
        if i > 0:
            name = name[:i]
    name = name.replace("void ", "").strip()
    return name[-n:]


def union(ops) -> list[tuple[float, float]]:
    """The union of the operations' [start, end) intervals, sorted."""
    out: list[list[float]] = []
    for o in sorted(ops, key=lambda o: o.start_us):
        if out and o.start_us <= out[-1][1]:
            out[-1][1] = max(out[-1][1], o.end_us)
        else:
            out.append([o.start_us, o.end_us])
    return [(a, b) for a, b in out]


def parse(events: list[dict], steps: int, wall_s: float) -> Trace:
    """A Chrome trace's ``traceEvents`` -> Trace."""
    launch_ts: dict[int, float] = {}
    ranges = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])
        elif cat == "user_annotation" and e.get("name") in RANGES:
            ranges.append((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        ops.append(DeviceOp(e.get("name", "?"), float(e["ts"]), float(e.get("dur", 0.0)),
                            label_of(launch_ts.get(corr), ranges)))
    return Trace(ops=ops, ranges=ranges, steps=steps, wall_s=wall_s)


def label_of(ts: float | None, ranges) -> str:
    """The innermost (shortest) harness range holding host time ``ts``."""
    if ts is None:
        return "other"
    best, best_len = "other", None
    for name, a, b in ranges:
        if a <= ts <= b and (best_len is None or b - a < best_len):
            best, best_len = name, b - a
    return "glue" if best == "step" else best


def capture(fn, steps: int, sync, cuda: bool = True) -> Trace:
    """Run ``fn()`` (which runs ``steps`` steps) under torch.profiler with
    the host and (``cuda``) device activities, synchronise, and parse the
    trace.  The trace file goes to the temporary directory and is
    deleted."""
    import time

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return parse(events, steps, wall)
