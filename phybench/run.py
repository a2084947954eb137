"""One run of one benchmark cell on the card.

    python3 -m phybench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run finds the cell in BENCHMARK.json and
its configuration, traffic mix and metric readers under ``phybench/``
(``spec.py``); draws the inputs from the seed; builds the measured
package's chained full-slot step and warms it up (``setup_s``, from the
start of this module); runs the mix's loop for ``--seconds`` (``loops.py``)
and ends the window with a device synchronisation; with ``--trace 1``
profiles a short steady sub-window and reads the per-layer metrics from it
(``trace.py``, ``metrics/``); reads the peak device memory, frees the
program's state, runs the plain reference on the last step's inputs and
compares (``check.py``).  It prints one JSON line as the last line of
standard output and each number compared beside its limit as the last
lines of standard error.

A run that finds no CUDA device, fewer devices than the cell asks for, or
``jax``, ``jaxlib``, ``flax`` or the JAX package loaded after the window
exits non-zero and prints no result.  The caches of the kernels' builds are
inside the checkout: the measured package builds its CUDA library into its
own ``_build/``, and the run points Triton's, Inductor's and CUDA's caches
at ``phybench/.cache/``.

``rehearse`` runs the same harness on the CPU at a tiny size, through the
measured package's plain decode, for the tests; it is never a measurement
and the command line cannot reach it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
CACHE = HERE / ".cache"
PACKAGE = "srsran_edgeric_5g_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "srsran_edgeric_5g_tpu")
# The UL results a stream batch copies to host memory before it counts as done.
UL_KEYS = ("payload", "tb_ok", "ack_bits", "csi_bits", "csi_ok", "prach_detected")
THREADS = 2


def set_cache_env() -> None:
    """Point every compile cache the run could touch inside the checkout,
    at fixed paths, before torch is imported; keep transformers-style
    loaders from importing JAX."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read (``metrics/``)."""

    loop: str
    issue_s: list
    trace: object = None              # trace.Trace of the profiled sub-window
    unprofiled_wall_s: float | None = None
    decode_bound_s: float | None = None


def _decode_bound(config: dict, results) -> float | None:
    """The roofline bound of one step's decode, averaged over the reference
    results given (one per noise sign)."""
    from .reference.parallel import full_cell as rfc
    from .reference.parallel import slot_pipeline as rsp
    from .roofline import ldpc_layered
    from .chain import full_cell_config

    seg, _ = rsp._plans(full_cell_config(rfc.FullCellConfig, config).ul_cell())
    bounds = [ldpc_layered.bound_s(seg.bg, seg.zc, int(r["sweeps"].sum()),
                                   r["sweeps"].numel()) for r in results]
    return sum(bounds) / len(bounds)


def chunk_rates(ends: list, n: int, work_per_step: float) -> list:
    """The rate (work per second) of each of ``n`` equal parts of a
    window, from each step's return time on the host."""
    if not ends:
        return []
    edges = [ends[-1] * k / n for k in range(n + 1)]
    out = []
    for a, b in zip(edges, edges[1:]):
        steps = sum(1 for t in ends if a < t <= b)
        out.append(round(steps * work_per_step / (b - a), 3) if b > a else None)
    return out


def _nvidia_smi() -> dict:
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    vals = [v.strip() for v in out.stdout.strip().split(",")]
    return dict(zip(q.split(","), vals)) if len(vals) == 6 else {}


def _cpu_model() -> str:
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    for line in out.splitlines():
        if line.startswith("Model name:"):
            return line.split(":", 1)[1].strip()
    return "unknown"


def host_syncs(fn) -> list[str]:
    """The synchronising CUDA calls that ``fn()`` makes, each as the
    file:line of the innermost frame of the measured package."""
    import traceback

    import torch

    found: list[str] = []
    running = False

    def hook(message, category, filename, lineno, file=None, line=None):
        if not running or "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if "/torch/" not in f.filename and "warnings" not in f.filename]
        frames = [f for f in stack if PACKAGE in f.filename] or stack[-1:]
        f = frames[-1]
        found.append(f"{pathlib.Path(f.filename).name}:{f.lineno} ({f.name})")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            running = True
            fn()
        finally:
            running = False
            torch.cuda.set_sync_debug_mode("default")
    return found


def run_cell(cell, seed: int, seconds: float, trace: bool, dev, t_start: float):
    """The run: (the result line's dict, earlier lines, check lines)."""
    import numpy as np
    import torch
    from torch.profiler import record_function

    from srsran_edgeric_5g_tpu_torch import cuda_build
    from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm

    from . import check, loops
    from . import trace as trace_mod
    from .chain import Chain, draw_inputs
    from .spec import load_reader

    tr, cfg = cell.traffic, cell.config
    s, loop = int(tr["slots"]), tr["loop"]
    is_cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if is_cuda else (lambda: None)
    torch.set_num_threads(THREADS)
    slot_s = 1e-3 / (1 << int(cfg.get("mu", 0)))
    info: list[str] = []

    t_in = time.perf_counter()
    x = draw_inputs(cfg, s, float(tr["snr_db"]), seed, dev)
    sync()
    t_warm = t_warm_first = time.perf_counter()
    ch = Chain(fcm, cfg, x, s, dev)
    for _ in range(int(tr["warmup_steps"])):
        ch()
        sync()
        info.append(f"# warm-up step {ch.steps}: {time.perf_counter() - t_warm} s")
        t_warm = time.perf_counter()
    if loop == "stream":
        depth = int(tr["depth"])
        period = s * slot_s
        bufs = [{k: torch.empty_like(ch.res[k], device="cpu", pin_memory=is_cuda)
                 for k in UL_KEYS} for _ in range(depth)]
        marks = loops.CudaMarks() if is_cuda else loops.HostMarks()

        def submit(b):
            with record_function("batch"):
                res = ch()
                for k in UL_KEYS:
                    bufs[b % depth][k].copy_(res[k], non_blocking=True)
                return marks.mark()

        loops.closed_stream(submit, marks, depth, depth)     # warm the copies
    sync()
    ch.reset_counts()
    launches0 = sum(cuda_build.LAUNCHES.values())
    setup_s = time.perf_counter() - t_start
    info.insert(0, f"# set-up: to the inputs {t_in - t_start} s (imports, device), "
                   f"inputs {t_warm_first - t_in} s")

    # ------------------------------------------------------------ window
    e2e: dict[str, float] = {}
    if loop == "batch":
        gc0 = [g["collections"] for g in gc.get_stats()]
        wall, issue, ends = loops.batch_window(ch, seconds, sync)
        e2e["x_real_time"] = ch.steps * s * slot_s / wall
        q = np.percentile(np.asarray(issue) * 1e3, [10, 50, 90, 100])
        info.append(f"# host issue ms per step p10 {q[0]} p50 {q[1]} p90 {q[2]} max {q[3]}")
        info.append(f"# x real time by fifths of the window (host clock): "
                    f"{chunk_rates(ends, 5, s * slot_s)}; gc collections "
                    f"{[g['collections'] - c for g, c in zip(gc.get_stats(), gc0)]}")
    elif loop == "stream":
        n_window = max(1, int(seconds / period))
        sr = loops.open_loop(submit, marks, n_window, period, depth)
        sync()
        lat = np.asarray(sr.latency_ms)
        issue = sr.issue_s
        e2e["latency_p50_ms"] = float(np.percentile(lat, 50))
        e2e["latency_p95_ms"] = float(np.percentile(lat, 95))
        info.append(f"# stream: {n_window} batches of {s} slots every {period * 1e3} ms, "
                    f"depth {depth}; latency ms p50 {e2e['latency_p50_ms']} p95 "
                    f"{e2e['latency_p95_ms']} max {float(lat.max())}; generator lateness ms "
                    f"p50 {statistics.median(sr.lateness_ms)} max {max(sr.lateness_ms)}; "
                    f"wall {sr.wall_s} s")
    else:
        raise ValueError(f"traffic {cell.traffic_name!r}: unknown loop {loop!r}")
    tb_fail = int(ch.bad)
    n_steps = ch.steps
    attempted = n_steps * ch.tbs_per_step
    last_td, last_res, last_flip = ch.td, ch.res, ch.last_flip()
    launches = (sum(cuda_build.LAUNCHES.values()) - launches0) / max(n_steps, 1)
    info.append(f"# window: {n_steps} steps of {s} slots in {seconds} s; setup_s {setup_s}; "
                f"CUDA kernel launches per step {launches}")

    readings = Readings(loop=loop, issue_s=issue)
    trace_out = None
    if trace:
        if loop == "batch":
            n_prof = int(tr["profile_steps"])

            def steps():
                for _ in range(n_prof):
                    ch()

            sync()
            t0 = time.perf_counter()
            steps()
            sync()
            readings.unprofiled_wall_s = time.perf_counter() - t0
            trace_out = trace_mod.capture(steps, n_prof, sync, cuda=is_cuda)
        else:
            n_prof = int(tr["profile_batches"])
            trace_out = trace_mod.capture(
                lambda: loops.open_loop(submit, marks, n_prof, period, depth),
                n_prof, sync, cuda=is_cuda)
        readings.trace = trace_out
        if is_cuda:
            syncs = host_syncs(ch)
            info.append(f"# host_syncs per step: {len(syncs)} {syncs[:8]}")
    peak = int(torch.cuda.max_memory_allocated(dev)) if is_cuda else 0
    smi = _nvidia_smi() if is_cuda else {}
    info.append(f"# card: {smi}; memory_peak_bytes {peak}")
    info.append(f"# host: {_cpu_model()}; affinity {len(os.sched_getaffinity(0))} cores; "
                f"torch threads {torch.get_num_threads()}")

    # ------------------------------------------- the check, after the window
    del ch
    if loop == "stream":
        del bufs
    if is_cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_td, ref_res = check.reference_step(cfg, x, s, last_flip, dev)
    numbers = check.compare(last_td, last_res, ref_td, ref_res, tb_fail)
    del ref_td
    if trace and loop == "batch":
        _, other = check.reference_step(cfg, x, s, -last_flip, dev, dl=False)
        readings.decode_bound_s = _decode_bound(cfg, [ref_res, other])
    info.append(f"# check: the reference took {time.perf_counter() - t_ref} s")
    limits = cfg["limits"]
    correct = check.judge(numbers, limits)

    metrics: dict[str, dict] = {}
    if not trace:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = load_reader(m["name"], cell.root).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu" if is_cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if is_cuda else "cpu",
              "count": 1, "memory_peak_bytes": peak,
              "power_limit": smi.get("power.limit", "not measured")}
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": tb_fail,
           "metrics": metrics, "device": device}
    if trace_out is not None:
        device["busy_s"] = trace_out.busy_s()
        device["window_s"] = trace_out.wall_s
        out["breakdown"] = {"device_ops": trace_out.top_ops(10),
                            "idle_gaps": trace_out.idle_gaps(10)}
    out["check"] = check.report(numbers, limits)
    return out, info, check.lines(numbers, limits)


def rehearse(workload: str, seed: int, seconds: float = 0.5, trace: bool = False,
             slots: int = 10, patch=None, bench: dict | None = None):
    """The harness on the CPU at ``slots`` slots per step through the
    measured package's plain versions, for the tests: (result, earlier
    lines, check lines).  ``patch(fcm)`` may replace the measured entry
    points for a fault test; ``bench`` stands in for BENCHMARK.json.
    Never a measurement."""
    import torch

    from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm

    from .spec import load_cell

    cell = load_cell(workload, bench=bench)
    cell.traffic = dict(cell.traffic, slots=slots, warmup_steps=1,
                        profile_steps=2, profile_batches=2)
    saved = {k: getattr(fcm, k) for k in dir(fcm) if k.startswith("gnb_")}
    try:
        if patch is not None:
            patch(fcm)
        return run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
    finally:
        for k, v in saved.items():
            setattr(fcm, k, v)


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m phybench.run",
                                description="One run of one benchmark cell on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    set_cache_env()
    import torch

    from .spec import load_cell

    if not torch.cuda.is_available():
        print("phybench: torch.cuda.is_available() is false; the benchmark runs "
              "on the card only", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"phybench: {cell.name} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out, info, check_lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                      dev, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"phybench: modules loaded that the run must not load: {bad}",
              file=sys.stderr)
        return 3
    for line in info:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    for line in check_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
