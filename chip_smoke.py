#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (srsran_edgeric_5g_tpu_torch) on one
NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   — nvcc-build every kernel in srsran_edgeric_5g_tpu_torch/csrc/
               (one process per source, in parallel); print the card.
  2. slice   — the main path: dl_slot_batch then ul_slot_batch at the 20 MHz
               cell (106 PRB, nfft 1536, 4 UEs x 26 PRB, 64QAM r0.5, S = 256
               slots) through 25 dB AWGN; every TB must pass CRC with the
               exact payload, also on a HARQ retransmission step; launch
               counts are read around this run only.
  3. small   — the same pipeline at a small cell on the CPU (plain decoder)
               and on the card (kernel): equal payloads and CRC flags.
  4. kernels — each kernel against its plain PyTorch version on the card at
               the main path's decode shape (2048 x 15232, BG1 Zc=224, the
               real decoder input of phase 2) and at BG2 Zc=128, both modes,
               fixed sweeps and early stop: equal hard bits, ok, sweeps.
  5. timing  — the DL+UL step chained over TIMED_STEPS steps; a per-stage
               breakdown; the kernel alone, its plain version, its bound.

Prints the card (nvidia-smi name, power limit), a JSON line per phase, the
{"kernels": [...]} line, and last {"ok": true, "device": {...}}.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

SEED = 1234
SNR_DB = 25.0
S_BATCH = 256
TIMED_STEPS = 20
NUM_ITERS = 6
# H100 SXM data sheet (see PERF.md): HBM
# rate, and the 32-bit ALU rate = 67 TFLOP/s fp32 (FMA counted as two) / 2.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12 / 2
# Arithmetic the layered check-node update needs per edge, lane and sweep
# (subtract, saturate, abs, min/second-min update, sign parity, magnitude
# select, scale, sign, add, pin) — a floor, not the kernel's instruction count.
OPS_PER_EDGE_LANE = 16


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def main_cell(sp):
    return sp.CellConfig(nof_prb=106, nfft=1536, nof_ue=4, prb_per_ue=26,
                         modulation="qam64", target_rate=0.5)


def awgn(td, snr_db, gen):
    """Complex AWGN at ``snr_db`` below the mean sample power."""
    import torch
    sigma = torch.sqrt(td.abs().pow(2).mean() * 10.0 ** (-snr_db / 10.0) / 2.0)
    re = torch.randn(td.shape, generator=gen, device=td.device)
    im = torch.randn(td.shape, generator=gen, device=td.device)
    return torch.complex(re, im) * sigma


def phase_slice(sp, cuda_build, dev, s_batch):
    """Drive the main path; return what later phases reuse."""
    import torch
    cell = main_cell(sp)
    u = cell.nof_ue
    gen = torch.Generator(device=dev).manual_seed(SEED)
    payloads = torch.randint(0, 2, (s_batch, u, cell.derived_tbs()),
                             generator=gen, device=dev, dtype=torch.int8)
    rntis = torch.arange(u, device=dev) + 0x4601
    t0 = time.perf_counter()
    cuda_build.reset_launches()
    td = sp.dl_slot_batch(payloads, rntis, cell, device=dev)
    noise = awgn(td, SNR_DB, gen)
    rx = td + noise
    pay, ok, nv, cfo, soft = sp.ul_slot_batch(rx, rntis, cell, device=dev)
    # HARQ: a new transmission through the returned carry (new_data = 1
    # clears it), then a chase-combined retransmission (new_data = 0).
    ones = torch.ones((s_batch, u), device=dev)
    pay2, ok2, _, _, soft2 = sp.ul_slot_batch(rx, rntis, cell, soft_buffer=soft,
                                              new_data=ones, device=dev)
    pay3, ok3, _, _, soft3 = sp.ul_slot_batch(rx, rntis, cell, soft_buffer=soft,
                                              new_data=0 * ones, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = dict(cuda_build.LAUNCHES)
    seconds = time.perf_counter() - t0

    seg, rm = sp._plans(cell)
    check(tuple(td.shape) == (s_batch, cell.timing.cp.total), f"DL shape {td.shape}")
    check(bool(torch.isfinite(td.real).all() and torch.isfinite(td.imag).all()),
          "DL samples finite")
    for tag, (p, o) in {"first": (pay, ok), "new_data": (pay2, ok2),
                        "combined": (pay3, ok3)}.items():
        check(bool(o.all()), f"{tag}: {int((~o).sum())} TBs failed CRC")
        check(torch.equal(p, payloads), f"{tag}: payload mismatch")
    check(tuple(soft.shape) == (s_batch, u * seg.c, rm.n_cb)
          and soft.dtype == torch.int8, f"soft carry {soft.shape} {soft.dtype}")
    check(torch.equal(soft2, soft), "new_data=1 must reproduce the fresh carry")
    check(bool((soft3.abs() >= soft.abs()).all()), "chase combine shrank |LLR|")
    check(bool(torch.isfinite(nv).all() and (nv > 0).all()), "noise variance")
    check(bool(torch.isfinite(cfo).all()), "cfo finite")
    emit("slice", cell="106PRB nfft1536 4UEx26PRB qam64 r0.5", slots=s_batch,
         snr_db=SNR_DB, tbs=cell.derived_tbs(), codeblocks=s_batch * u * seg.c,
         bg=seg.bg, zc=seg.zc, e=rm.e, n_cb=rm.n_cb, seconds=seconds,
         tb_ok=int(ok.sum()), launches=launches,
         mean_noise_var=float(nv.mean()))
    return dict(cell=cell, payloads=payloads, rntis=rntis, noise=noise, rx=rx,
                launches=launches)


def phase_small(sp, dev):
    """Small cell on the CPU (plain versions) and on ``dev``: same result."""
    import numpy as np
    import torch
    cell = sp.CellConfig(nof_prb=52, nfft=768, nof_ue=4, prb_per_ue=12,
                         modulation="qam16", target_rate=0.4)
    rng = np.random.default_rng(SEED)
    pay = rng.integers(0, 2, (2, 4, cell.derived_tbs()), dtype=np.int8)
    rntis = 0x4601 + np.arange(4)
    out = {}
    for d in (torch.device("cpu"), dev):
        td = sp.dl_slot_batch(pay, rntis, cell, device=d).cpu()
        out[d.type] = [td]
    td = out["cpu"][0].numpy()
    nvar = float(np.mean(np.abs(td) ** 2)) * 10 ** (-20 / 10)
    noise = (rng.normal(size=td.shape) + 1j * rng.normal(size=td.shape)) \
        * np.sqrt(nvar / 2)
    rx = (td + noise).astype(np.complex64)
    for d in (torch.device("cpu"), dev):
        res = sp.ul_slot_batch(rx, rntis, cell, device=d)
        out[d.type] += [r.cpu() for r in res]
    a, b = out["cpu"], out[dev.type]
    dl_err = float((a[0] - b[0]).abs().max() / a[0].abs().max())
    check(dl_err < 1e-5, f"small cell DL rel err {dl_err}")
    check(bool(a[2].all()), "small cell CPU CRC")
    check(torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]),
          "small cell payload/CRC differ between CPU and card")
    check(torch.equal(a[1], torch.as_tensor(pay)), "small cell payload")
    soft_diff = int((a[5] != b[5]).sum())
    check(soft_diff <= 1e-3 * a[5].numel(), f"small cell carry differs in {soft_diff}")
    emit("small", cell="52PRB nfft768 4UEx12PRB qam16 r0.4", dl_rel_err=dl_err,
         carry_entries_differing=soft_diff, carry_entries=a[5].numel())


def synthetic_wire(encoder, dev, bg, zc, b, snr_db, gen):
    """(float32 LLRs, int8 wire LLRs) of random codewords through BPSK AWGN."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph
    g = get_graph(bg, zc)
    msgs = torch.randint(0, 2, (b, g.k), generator=gen, device=dev, dtype=torch.int8)
    cw = encoder.encode(msgs, bg, zc)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2 * cw[:, 2 * zc:].float()) + sigma * torch.randn(
        cw[:, 2 * zc:].shape, generator=gen, device=dev)
    llr = torch.cat([torch.zeros((b, 2 * zc), device=dev), 2 * y / sigma ** 2], 1)
    wire = torch.clamp(torch.round(torch.clamp(llr, -20, 20) * 6.0), -120, 120)
    return llr.contiguous(), wire.to(torch.int8).contiguous()


def phase_kernels(sp, dec, encoder, dev, ctx):
    """Kernel == plain at the main-path decode shape and at BG2 Zc=128."""
    import torch
    cell = ctx["cell"]
    seg, _ = sp._plans(cell)
    llr, _, _ = sp._ul_front(ctx["rx"], ctx["rntis"], cell)
    full = sp._decoder_input(llr.reshape(-1, llr.shape[-1]), cell)
    ctx["decoder_input"] = full
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bg2_f32, bg2_wire = synthetic_wire(encoder, dev, 2, 128, full.shape[0], 1.5, gen)
    cases = [(f"BG{seg.bg} Zc={seg.zc}", seg.bg, seg.zc,
              {True: full, False: (full.float() / 6.0).contiguous()}),
             ("BG2 Zc=128", 2, 128, {True: bg2_wire, False: bg2_f32})]
    max_err = 0
    for name, bg, zc, inputs in cases:
        for wire, x in inputs.items():
            for early_stop in (False, True):
                k = dec.decode_layered(x, bg, zc, NUM_ITERS, wire=wire,
                                       early_stop=early_stop)
                p = dec.decode_layered_plain(x, bg, zc, NUM_ITERS, wire=wire,
                                             early_stop=early_stop)
                err = int((k[0].int() - p[0].int()).abs().max())
                max_err = max(max_err, err)
                same = all(torch.equal(a, b) for a, b in zip(k, p))
                check(same, f"{name} wire={wire} early_stop={early_stop}: "
                            f"kernel != plain (max |hard diff| {err})")
                emit("kernel_vs_plain", case=name, mode="wire" if wire else "f32",
                     early_stop=early_stop, codeblocks=x.shape[0], equal=same,
                     ok=int(k[1].sum()), mean_sweeps=float(k[2].float().mean()))
    return max_err


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(sp, dec, dev, ctx):
    import torch
    cell = ctx["cell"]
    t = cell.timing
    payloads, rntis, noise = ctx["payloads"], ctx["rntis"], ctx["noise"]
    s_batch = payloads.shape[0]

    def step(eps):
        td = sp.dl_slot_batch(payloads ^ eps, rntis, cell, device=dev)
        res = sp.ul_slot_batch(td + noise, rntis, cell, device=dev)
        return res[0][0, 0, 0] & 0, res[1]

    eps = torch.zeros((), dtype=torch.int8, device=dev)
    for _ in range(2):
        eps, ok = step(eps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        eps, ok = step(eps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(ok.all()), "timed steps: CRC")
    slot_ms = dt / (TIMED_STEPS * s_batch) * 1e3
    slot_duration_ms = 1.0 / (1 << cell.mu)
    emit("e2e", steps=TIMED_STEPS, slots_per_step=s_batch, seconds=dt,
         ms_per_slot=slot_ms, x_real_time=slot_duration_ms / slot_ms,
         samples_per_s=TIMED_STEPS * s_batch * t.cp.total / dt,
         srate=t.srate, peak_mem_bytes=torch.cuda.max_memory_allocated())

    # Per-stage device time of one step (CUDA events, mean of 5).
    full = ctx["decoder_input"]
    seg, _ = sp._plans(cell)
    td = sp.dl_slot_batch(payloads, rntis, cell, device=dev)
    rx = td + noise
    llr = sp._ul_front(rx, rntis, cell)[0].reshape(s_batch * cell.nof_ue, -1)
    from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder, segmenter
    hard, _ = decoder.decode(full, seg.bg, seg.zc, NUM_ITERS, schedule="wire_auto")
    stages = {
        "dl_code": lambda: sp._dl_code(payloads.reshape(-1, payloads.shape[-1]),
                                       rntis, cell),
        "dl_slot_batch": lambda: sp.dl_slot_batch(payloads, rntis, cell, device=dev),
        "ul_front": lambda: sp._ul_front(rx, rntis, cell),
        "ul_dematch": lambda: sp._decoder_input(llr, cell),
        "ul_decode": lambda: decoder.decode(full, seg.bg, seg.zc, NUM_ITERS,
                                            schedule="wire_auto"),
        "ul_desegment": lambda: segmenter.desegment_tb(hard, seg),
        "ul_slot_batch": lambda: sp.ul_slot_batch(rx, rntis, cell, device=dev),
    }
    emit("breakdown_ms_per_step", slots_per_step=s_batch,
         **{k: cuda_ms(f, 5) for k, f in stages.items()})

    # The kernel alone at the main path's settings (wire, early stop), its
    # plain version, fixed-sweep and f32-mode times, and the bound.
    bg, zc = seg.bg, seg.zc
    from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph
    g = get_graph(bg, zc)
    _, _, sweeps = dec.decode_layered(full, bg, zc, NUM_ITERS, wire=True,
                                      early_stop=True)
    ms = cuda_ms(lambda: dec.decode_layered(full, bg, zc, NUM_ITERS, wire=True,
                                            early_stop=True), 20)
    ms_fixed = cuda_ms(lambda: dec.decode_layered(full, bg, zc, NUM_ITERS,
                                                  wire=True, early_stop=False), 10)
    f32_in = (full.float() / 6.0).contiguous()
    ms_f32 = cuda_ms(lambda: dec.decode_layered(f32_in, bg, zc, NUM_ITERS,
                                                wire=False, early_stop=False), 5)
    plain_ms = cuda_ms(lambda: dec.decode_layered_plain(
        full, bg, zc, NUM_ITERS, wire=True, early_stop=True), 3, warmup=1)
    total_sweeps = int(sweeps.sum())
    ops = OPS_PER_EDGE_LANE * g.num_edges * zc * total_sweeps
    n_bytes = full.numel() + full.shape[0] * (g.kb * zc + 1 + 4)
    t_ops, t_bytes = ops / ALU_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    emit("kernel_time", kernel="ldpc_layered", codeblocks=full.shape[0],
         sweeps_total=total_sweeps, mean_sweeps=total_sweeps / full.shape[0],
         wire_early_stop_ms=ms, wire_fixed_6_ms=ms_fixed, f32_fixed_6_ms=ms_f32,
         plain_wire_early_stop_ms=plain_ms, ops=ops, bytes=n_bytes,
         bound_ops_ms=t_ops, bound_bytes_ms=t_bytes)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    try:
        from srsran_edgeric_5g_tpu_torch import cuda_build
        from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder_cuda, encoder
        from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as sp
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]

    t0 = time.perf_counter()
    cuda_build.build_all()
    for name in cuda_build.KERNELS:
        cuda_build.load(name)
    regs = [ln.strip() for log in cuda_build.BUILD_LOGS.values()
            for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, kernels=list(cuda_build.KERNELS),
         ptxas=regs, torch=torch.__version__, cuda=torch.version.cuda)

    ctx = phase_slice(sp, cuda_build, dev, S_BATCH)
    check(ctx["launches"].get(decoder_cuda.KERNEL, 0) > 0,
          f"main path launched no {decoder_cuda.KERNEL} kernel")
    phase_small(sp, dev)
    max_err = phase_kernels(sp, decoder_cuda, encoder, dev, ctx)
    tm = phase_timing(sp, decoder_cuda, dev, ctx)

    leaked = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or m == "srsran_edgeric_5g_tpu" or m.startswith("srsran_edgeric_5g_tpu.")]
    check(not leaked, f"JAX modules imported: {leaked[:5]}")

    kernels = [{
        "name": decoder_cuda.KERNEL, "route": "cuda",
        "source": "srsran_edgeric_5g_tpu_torch/csrc/ldpc_layered.cu",
        "replaces": "srsran_edgeric_5g_tpu/ops/ldpc/decoder_pallas.py:211",
        "launches": ctx["launches"].get(decoder_cuda.KERNEL, 0),
        "max_abs_err": max_err, "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": None,
    }]
    check(all(math.isfinite(k["ms"]) and k["ms"] > 0 for k in kernels), "kernel times")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
