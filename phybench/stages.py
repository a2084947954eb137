"""The program's own stage spans in a traced run, and its build counter.

The measured package opens ``phy.*`` ranges at its stage boundaries
(``utils/tracing.py``: ``phy.dl`` / ``phy.ul`` around each full-slot
entry point, ``phy.dl.code``, ``phy.ul.decode`` and the rest inside), and
counts the misses of its cached table builders.  ``trace.py`` keeps the
harness's own ranges only, so a traced run reads the stages from a second
sub-window of the same cell (cell and seed from its command line, a new
chain warmed): ``profile_steps`` steps plain, then with the program's tracer
enabled and a sync before each step (the host's issue time, unprofiled),
then under a profiler that records the host's ``record_function`` ranges
but no operator, so that the host runs at its own pace.  That trace gives
each device operation its launch call's host time and the innermost
``phy.*`` range holding that launch, on one clock in microseconds.

The capture runs once per run, from the first reader that asks for it
(``of``), and stays on the run's readings; it prints the stage, idle-gap,
coverage and on-cost tables on standard error.  ``setup_builds`` reads the
build counter once, from the first reader that asks (``setup_build_s``,
read before the capture), and prints it by builder.  Where the run is not
``python3 -m phybench.run`` (the CPU tests' ``rehearse``) or the measured
package has no build counter (no stage spans either), both give None.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import tempfile
import time

from .trace import DEVICE_CATS, short

PREFIX = "phy."
TOPS = ("phy.dl", "phy.ul")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    start_us: float
    dur_us: float
    launch_us: float | None     # the host time of the call that launched it
    span: str                   # the innermost phy.* range of that call, or ""

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


@dataclasses.dataclass(frozen=True)
class Gap:
    start_us: float             # the end of the busy interval before it
    dur_us: float
    host_span: str              # the innermost phy.* range the host was in then
    late: bool                  # the op ending it was launched after it began
    next_op: str


@dataclasses.dataclass
class Stages:
    ops: list[Op]
    spans: list[tuple[str, float, float]]   # (name, start_us, end_us), host
    steps: int
    host_own: float | None = None           # host_own_ms, from the unprofiled pass
    notes: dict = dataclasses.field(default_factory=dict)

    def device_ms(self, *names: str) -> float | None:
        """Device ms per step of the operations whose innermost span is one
        of ``names`` or nested in one; None if there are none."""
        ops = [o for o in self.ops if any(within(o.span, n) for n in names)]
        return 1e-3 * sum(o.dur_us for o in ops) / self.steps if ops else None

    def own_ms(self, name: str) -> float:
        """Device ms per step of the operations whose innermost span is
        ``name`` itself (launched in it, outside its child spans)."""
        return 1e-3 * sum(o.dur_us for o in self.ops if o.span == name) / self.steps

    def host_ms(self, name: str) -> float:
        """Host ms per step inside the spans named ``name``."""
        return 1e-3 * sum(b - a for n, a, b in self.spans if n == name) / self.steps

    @functools.cached_property
    def gaps(self) -> list[Gap]:
        """Every gap between busy intervals, in time order."""
        out, end = [], None
        for o in sorted(self.ops, key=lambda o: o.start_us):
            if end is not None and o.start_us > end:
                out.append(Gap(end, o.start_us - end, innermost(self.spans, end),
                               o.launch_us is not None and o.launch_us > end,
                               short(o.name)))
            end = o.end_us if end is None else max(end, o.end_us)
        return out

    def idle_ms(self, late_only: bool = False) -> float:
        """Device idle ms per step between its first and last operation
        (``late_only``: in the gaps where it waited on the host)."""
        return 1e-3 * sum(g.dur_us for g in self.gaps
                          if g.late or not late_only) / self.steps

    def lines(self) -> list[str]:
        """The tables this run prints on standard error."""
        names = sorted({n for n, _, _ in self.spans})
        out = [f"# stages ({self.steps} profiled steps; ms per step): span, device ms "
               f"launched under it, of which in itself, host ms inside it"]
        for n in names:
            out.append(f"#   {n}: device {self.device_ms(n) or 0.0} own {self.own_ms(n)} "
                       f"host {self.host_ms(n)}")
        for top in TOPS:
            whole = self.device_ms(top) or 0.0
            share = 100.0 * self.own_ms(top) / whole if whole else 0.0
            out.append(f"# coverage {top}: device ms outside every stage span "
                       f"{self.own_ms(top)} of {whole} ({share} %)")
        gaps = self.gaps
        out.append(f"# idle gaps: {len(gaps)}, {self.idle_ms()} ms per step, late "
                   f"{self.idle_ms(late_only=True)}; the ten longest (ms, host span "
                   f"when the gap began, late or queued, next op):")
        for g in sorted(gaps, key=lambda g: -g.dur_us)[:10]:
            out.append(f"#   {g.dur_us * 1e-3} {g.host_span or '-'} "
                       f"{'late' if g.late else 'queued'} {g.next_op}")
        out += [f"# {k}: {v}" for k, v in self.notes.items()]
        return out


def within(span: str, name: str) -> bool:
    return span == name or span.startswith(name + ".")


def innermost(spans, t: float | None) -> str:
    """The shortest span holding host time ``t``, or ""."""
    best, best_len = "", None
    if t is None:
        return best
    for name, a, b in spans:
        if a <= t <= b and (best_len is None or b - a < best_len):
            best, best_len = name, b - a
    return best


def parse(events: list[dict], steps: int) -> Stages:
    """A Chrome trace's ``traceEvents`` -> Stages."""
    launch: dict[int, float] = {}
    spans = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in RUNTIME_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = float(e["ts"])
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(PREFIX):
            spans.append((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t = launch.get((e.get("args") or {}).get("correlation"))
        ops.append(Op(e.get("name", "?"), float(e["ts"]), float(e.get("dur", 0.0)), t,
                      innermost(spans, t)))
    return Stages(ops=ops, spans=spans, steps=steps)


def host_own_ms(events: list[dict], steps: int) -> float | None:
    """Host ms per step inside the tracer's ``phy.dl`` / ``phy.ul`` events."""
    tops = [float(e["dur"]) for e in events if e.get("name") in TOPS]
    return 1e-3 * sum(tops) / steps if tops else None


def profile_events(fn, sync, cuda: bool = True) -> tuple[list[dict], float]:
    """Run ``fn()`` under the profiler, synchronise: (the Chrome trace's
    events, the wall s).  It records the host's ``record_function`` ranges
    (the user scope) but no operator, and with ``cuda`` the runtime and
    driver calls and the device operations."""
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import RecordScope
    from torch.autograd import profiler

    p = profiler.profile(use_device="cuda" if cuda else None, use_kineto=True)
    config, acts = p.config(), p.kineto_activities
    _prepare_profiler(config, acts)
    sync()
    _enable_profiler(config, acts, {RecordScope.USER_SCOPE})
    try:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    finally:
        result = _disable_profiler()
    with tempfile.TemporaryDirectory() as d:
        result.save(os.path.join(d, "trace.json"))
        with open(os.path.join(d, "trace.json")) as f:
            return json.load(f).get("traceEvents", []), wall


def measure(cell, seed: int, dev) -> Stages:
    """The cell's chained step on ``dev``, warmed, then ``profile_steps``
    steps plain, traced by the program with a sync before each, profiled."""
    import torch

    from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm
    from srsran_edgeric_5g_tpu_torch.utils.tracing import l1_tracer

    from .chain import Chain, draw_inputs

    tr = cell.traffic
    s, n = int(tr["slots"]), int(tr["profile_steps"])
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    x = draw_inputs(cell.config, s, float(tr["snr_db"]), seed, dev)
    ch = Chain(fcm, cell.config, x, s, dev)

    def steps(drain: bool = False):
        for _ in range(n):
            if drain:           # no launch waits for room in the queue
                sync()
            ch()

    def timed(drain: bool = False) -> float:
        sync()
        t0 = time.perf_counter()
        steps(drain)
        sync()
        return time.perf_counter() - t0

    for _ in range(int(tr["warmup_steps"])):
        ch()
    plain_s = timed()
    l1_tracer.enable()
    try:
        drained_s = timed(drain=True)
        host = list(l1_tracer._events)
    finally:
        l1_tracer.disable()
        l1_tracer.clear()
    events, wall = profile_events(steps, sync, cuda)
    st = parse(events, n)
    st.host_own = host_own_ms(host, n)
    st.notes["on-cost, wall s of the same steps"] = (
        f"plain {plain_s}, profiled {wall} ({wall / plain_s}x), l1_tracer enabled "
        f"with a sync before each step {drained_s}; host_own_ms {st.host_own}")
    return st


def k1_line(st: Stages) -> str:
    """Where the kernels that ``decode_roofline`` reads were launched."""
    from .spec import load_reader

    pats = load_reader("decode_roofline").PATTERNS
    k1 = [o for o in st.ops if any(p.search(o.name) for p in pats)]
    ms = 1e-3 * sum(o.dur_us for o in k1) / st.steps
    return (f"{len(k1)} ops, innermost spans {sorted({o.span for o in k1})}, "
            f"{ms} device ms per step; phy.ul.decode {st.device_ms('phy.ul.decode')}")


def run_args():
    """The command line of ``python3 -m phybench.run``, when that is this
    process; else None."""
    main = sys.modules.get("__main__")
    spec = getattr(main, "__spec__", None)
    if spec is None or spec.name != "phybench.run":
        return None
    return main.parse(sys.argv[1:])


def _counter():
    """The measured package's build counter, or None where it has none."""
    from srsran_edgeric_5g_tpu_torch.utils import tracing

    return getattr(tracing, "builds", None)


def of(r) -> Stages | None:
    """The traced batch run's stage capture, made at the first call."""
    if r.loop != "batch" or r.trace is None:
        return None
    if "stages" not in vars(r):
        r.stages = None
        args = run_args()
        if args is not None and _counter() is not None:
            import torch

            from .spec import load_cell

            r.stages = measure(load_cell(args.workload), args.seed,
                               torch.device("cuda", torch.cuda.current_device()))
            r.stages.notes["K1 kernels"] = k1_line(r.stages)
            for line in r.stages.lines():
                print(line, file=sys.stderr)
    return r.stages


def setup_builds(r) -> dict | None:
    """{builder: (misses, exclusive s)} of the traced run's set-up, read
    at the first call (the window and the profiled steps build nothing)."""
    if r.trace is None:
        return None
    if "builds" not in vars(r):
        counter = _counter() if run_args() is not None else None
        r.builds = None if counter is None else counter.snapshot()
        if r.builds is not None:
            print(build_lines(r.builds), file=sys.stderr)
    return r.builds


def build_s(builds: dict) -> float:
    """The builders' exclusive seconds, nvcc's left out: it runs only where
    the checkout has not built the library yet."""
    return sum(s for k, (_, s) in builds.items() if not k.startswith("nvcc."))


def build_lines(builds: dict) -> str:
    rows = sorted(builds.items(), key=lambda kv: -kv[1][1])
    return "\n".join([f"# builds in set-up: {build_s(builds)} s exclusive without nvcc, "
                      f"{len(rows)} builders (builder: s, misses)"]
                     + [f"#   {k}: {s} {m}" for k, (m, s) in rows])
