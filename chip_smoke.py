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
  6. full_cell — the full gNB slot (bench.py's bench_full_cell) at
               FullCellConfig() (20 MHz, 106 PRB, 4 UEs, 64QAM) and S = 256:
               UE UL generated once, 25 dB AWGN, one DL+UL step with the
               HARQ carry and new_data = 1, bench.py's asserts (PUSCH CRC +
               exact payload, exact F1 ACKs, F2 CSI valid and exact, PRACH
               preamble 7 alone on every occasion); K1's launches are read
               around this run.  Then FC_TIMED_STEPS chained steps (ms per
               slot, x real time, samples/s), a per-channel breakdown, and
               the device's busy time and idle share over chained steps
               (torch.profiler's device records).
  7. kernel_int8 — K2 (decode_int8) against its plain version on the card:
               BG1 Zc=384 B=128 at 100 dB and 6.5 dB (the shape of
               tools/tpu_pallas_earlystop.py) and the full cell's decoder
               input (2048 x 15232), early stop off/on, b_tile 1 and 32:
               equal hard bits, ok, sweeps.  K2's own path (decode_int8 as
               its callers call it, on the full cell's decoder input) is
               driven with the counts reset around it; its time, its plain
               version's time, its bound.

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
FC_TIMED_STEPS = 30      # bench.py's ITERS
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
    n_bytes = full.numel() + full.shape[0] * (g.kb * zc + 1 + 4)
    bound_ms, bound_by = kernel_bound(g, zc, total_sweeps, n_bytes)
    emit("kernel_time", kernel="ldpc_layered", codeblocks=full.shape[0],
         sweeps_total=total_sweeps, mean_sweeps=total_sweeps / full.shape[0],
         wire_early_stop_ms=ms, wire_fixed_6_ms=ms_fixed, f32_fixed_6_ms=ms_f32,
         plain_wire_early_stop_ms=plain_ms, bytes=n_bytes, bound_ms=bound_ms,
         bound_by=bound_by)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def kernel_bound(g, zc, total_sweeps, n_bytes):
    """(bound ms, what bounds it): the layered update's operation floor for
    the sweeps this run's data needed, or its bytes, whichever is longer."""
    ops = OPS_PER_EDGE_LANE * g.num_edges * zc * total_sweeps
    t_ops, t_bytes = ops / ALU_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_full_cell(fcm, sp, cuda_build, dec, dev):
    """bench.py's bench_full_cell on the port: asserts, K1's launches, the
    chained timed steps and the per-channel breakdown."""
    import torch
    fc = fcm.FullCellConfig()
    s, u = S_BATCH, fc.nof_ue
    t = fc.timing
    cell_u = fc.ul_cell()
    seg, rm = sp._plans(cell_u)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def bits(*shape):
        return torch.randint(0, 2, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    norm_idx, ssb_idx = fc.norm_slots(s), fc.ssb_slots(s)
    pay_n = bits(len(norm_idx), u, fc.dl_cell().derived_tbs())
    pay_s = bits(len(ssb_idx), u, fc.dl_cell_ssb().derived_tbs())
    dci = bits(s, 2 * u, fc.dci_bits)
    pbch = bits(len(ssb_idx), 24)
    pay_u = bits(s, u, cell_u.derived_tbs())
    ack = bits(s, u, 2)
    csi = bits(len(fc.csi_slots(s)), u, fc.csi_bits)

    ul = fcm.ue_ul_slot_batch(pay_u, ack, csi, fc, s, device=dev)
    noise = awgn(ul, SNR_DB, gen)
    ones = torch.ones((s, u), device=dev)
    soft0 = torch.zeros((s * u * seg.c, rm.n_cb), dtype=torch.int8, device=dev)

    def step(pn, eps, flip, soft):
        """One full-cell DL TX + UL RX slot batch, chained as bench.py."""
        td = fcm.gnb_dl_slot_batch(pn ^ eps, pay_s, dci, pbch, fc, s, device=dev)
        dl_pow = (td.real ** 2 + td.imag ** 2).mean()
        res = fcm.gnb_ul_slot_batch(ul + noise * flip, fc, s, soft_in=soft,
                                    new_data=ones, soft_flat=True, device=dev)
        eps_next = (res["payload"][0, 0, 0] & 0) | (dl_pow > 1e30).to(torch.int8)
        return res, eps_next, -flip, td

    eps = torch.zeros((), dtype=torch.int8, device=dev)
    flip = torch.ones((), device=dev)
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    res, eps, flip, td = step(pay_n, eps, flip, soft0)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    first_s = time.perf_counter() - t0
    check(tuple(td.shape) == (s, t.cp.total) and bool(torch.isfinite(td.real).all()
                                                      and torch.isfinite(td.imag).all()),
          f"full cell DL samples {tuple(td.shape)}")
    ok = res["tb_ok"]
    check(bool(ok.all()), f"PUSCH CRC failed: {int(ok.sum())}/{ok.numel()}")
    check(torch.equal(res["payload"], pay_u), "PUSCH payload mismatch")
    check(torch.equal(res["ack_bits"], ack), "PUCCH F1 ACK mismatch")
    check(bool(res["csi_ok"].all()), "PUCCH F2 CSI not valid")
    check(torch.equal(res["csi_bits"], csi), "PUCCH F2 CSI mismatch")
    det = res["prach_detected"]
    others = torch.ones(64, dtype=torch.bool, device=dev)
    others[7] = False
    check(bool(det[:, 7].all()) and not bool(det[:, others].any()),
          f"PRACH detection wrong: {torch.nonzero(det).tolist()[:8]}")
    check(tuple(res["soft"].shape) == (s * u * seg.c, rm.n_cb)
          and res["soft"].dtype == torch.int8, "flat HARQ carry")
    check(launches.get(dec.KERNEL, 0) > 0,
          f"the full cell launched no {dec.KERNEL} kernel")
    emit("full_cell", cell="FullCellConfig() 106PRB nfft1536 4UE qam64 r0.5",
         slots=s, snr_db=SNR_DB, tbs_ul=cell_u.derived_tbs(),
         codeblocks=s * u * seg.c, bg=seg.bg, zc=seg.zc, e=rm.e, n_cb=rm.n_cb,
         carry_bytes=res["soft"].numel(), first_step_seconds=first_s,
         launches=launches, tb_ok=int(ok.sum()),
         prach_occasions=int(det.shape[0]),
         srs_snr_db_mean=float(res["srs_snr_db"].mean()),
         prach_delay=sorted(set(res["prach_delay"][:, 7].tolist())))

    for _ in range(2):
        res, eps, flip, _ = step(pay_n, eps, flip, res["soft"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FC_TIMED_STEPS):
        res, eps, flip, _ = step(pay_n, eps, flip, res["soft"])
    _ = int(eps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(res["tb_ok"].all()), "full cell timed steps: CRC")
    slot_ms = dt / (FC_TIMED_STEPS * s) * 1e3
    emit("full_cell_e2e", steps=FC_TIMED_STEPS, slots_per_step=s, seconds=dt,
         ms_per_slot=slot_ms, x_real_time=(1.0 / (1 << fc.mu)) / slot_ms,
         samples_per_s=t.cp.total / (slot_ms * 1e-3), srate=t.srate,
         peak_mem_bytes=torch.cuda.max_memory_allocated())

    # Per-channel device time of one step (CUDA events, mean of 5).
    from srsran_edgeric_5g_tpu_torch.ops import ofdm, prach
    from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder
    rntis = fcm._rntis(fc, dev)
    cell_n, cell_s = fc.dl_cell(), fc.dl_cell_ssb()
    rx = ul + noise
    grid = ofdm.demodulate_slot(td, t, scale=float(t.nfft))
    rx_grid = ofdm.demodulate_slot(rx, t, scale=1.0)
    llr = sp._ul_front(None, rntis, cell_u, rx_grid=rx_grid)[0].reshape(s * u, -1)
    full = sp._decoder_input(llr, cell_u)
    info = fc.prach_info()
    win = fcm._slot_take(rx, fc.prach_slots(s))[:, :info.cp_samples + info.dft_size]
    stages = {
        "dl_total": lambda: fcm.gnb_dl_slot_batch(pay_n, pay_s, dci, pbch, fc, s,
                                                  device=dev),
        "dl_pdsch_code": lambda: (
            sp._dl_code(pay_n.reshape(-1, pay_n.shape[-1]), rntis, cell_n),
            sp._dl_code(pay_s.reshape(-1, pay_s.shape[-1]), rntis, cell_s)),
        "dl_pdcch": lambda: fcm.pdcch_rows(dci, fc, s),
        "dl_ssb": lambda: fcm.ssb_blocks(pbch, fc, s),
        "dl_ofdm_mod": lambda: ofdm.modulate_slot(grid, t, scale=1.0 / t.nfft),
        "ul_total": lambda: fcm.gnb_ul_slot_batch(rx, fc, s, soft_in=soft0,
                                                  new_data=ones, soft_flat=True,
                                                  device=dev),
        "ul_ofdm_demod": lambda: ofdm.demodulate_slot(rx, t, scale=1.0),
        "ul_pusch_front": lambda: sp._ul_front(None, rntis, cell_u, rx_grid=rx_grid),
        "ul_dematch": lambda: sp._decoder_input(llr, cell_u, 0, soft0, ones.reshape(-1)),
        "ul_decode": lambda: decoder.decode(full, seg.bg, seg.zc, NUM_ITERS,
                                            schedule="wire_auto"),
        "ul_pucch_f1": lambda: fcm._f1_detect(rx_grid, fc, s),
        "ul_pucch_f2": lambda: fcm._f2_decode(fcm._slot_take(rx_grid, fc.csi_slots(s)),
                                              fc, s),
        "ul_srs": lambda: fcm._srs_estimate(fcm._slot_take(rx_grid, fc.srs_slots(s)), fc),
        "ul_prach": lambda: fcm._prach_detect_batch(
            prach.ofdm_demodulate_prach(win, info), fc),
    }
    emit("full_cell_breakdown_ms_per_step", slots_per_step=s,
         **{k: cuda_ms(f, 5) for k, f in stages.items()})

    # Device busy time of the chained step from the profiler's device
    # records (the union of their intervals), against the unprofiled wall
    # time per step above: the device's idle share.
    from torch.profiler import ProfilerActivity, profile
    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            res, eps, flip, _ = step(pay_n, eps, flip, res["soft"])
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, -math.inf
    by_name = {}
    for e in sorted(dev_events, key=lambda e: e.time_range.start):
        t0_us, t1_us = e.time_range.start, e.time_range.end
        if t1_us > end:
            busy_us += t1_us - max(t0_us, end)
            end = t1_us
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + (t1_us - t0_us)
    wall_ms = slot_ms * s
    busy_ms = busy_us / n_prof / 1e3 if dev_events else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit("full_cell_device_profile", steps=n_prof, wall_ms_per_step=wall_ms,
         device_busy_ms_per_step=busy_ms,
         idle_share=None if busy_ms is None else 1.0 - busy_ms / wall_ms,
         device_ops_per_step=len(dev_events) / n_prof,
         top_ms_per_step={k: v / n_prof / 1e3 for k, v in top})
    return dict(decoder_input=full, launches=launches)


def tools_shape_llrs(encoder, dev, snr_db, gen):
    """tools/tpu_pallas_earlystop.py's input: BG1 Zc=384, B=128, BPSK
    codewords, LLRs clipped to ±120, the 2*Zc punctured columns zero."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph
    bg, zc, b = 1, 384, 128
    g = get_graph(bg, zc)
    msgs = torch.randint(0, 2, (b, g.k), generator=gen, device=dev, dtype=torch.int8)
    sym = 1 - 2 * encoder.encode(msgs, bg, zc).float()
    sigma = 10 ** (-snr_db / 20)
    y = sym + sigma * torch.randn(sym.shape, generator=gen, device=dev)
    llr = 20 * torch.clamp(2 * y / max(sigma, 1e-3) ** 2 / 20, -6.0, 6.0)
    llr[:, :2 * zc] = 0
    return llr.contiguous()


def phase_kernel_int8(dec, encoder, cuda_build, dev, full):
    """K2 == plain on the card; K2's own path, its times and bound."""
    import torch
    from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cases = [(f"BG1 Zc=384 B=128 {snr} dB", 1, 384,
              tools_shape_llrs(encoder, dev, snr, gen)) for snr in (100.0, 6.5)]
    cases.append((f"full cell decoder input {tuple(full.shape)}", 1, 224, full))
    max_err = 0
    for name, bg, zc, x in cases:
        for early_stop in (False, True):
            for b_tile in (1, 32):
                k = dec.decode_int8(x, bg, zc, NUM_ITERS, b_tile, early_stop,
                                    with_sweeps=True)
                p = dec.decode_int8_plain(x, bg, zc, NUM_ITERS, b_tile, early_stop,
                                          with_sweeps=True)
                err = int((k[0].int() - p[0].int()).abs().max())
                max_err = max(max_err, err)
                same = all(torch.equal(a, b) for a, b in zip(k, p))
                check(same, f"K2 {name} early_stop={early_stop} b_tile={b_tile}: "
                            f"kernel != plain (max |hard diff| {err})")
                emit("kernel_int8_vs_plain", case=name, early_stop=early_stop,
                     b_tile=b_tile, codeblocks=x.shape[0], equal=same,
                     ok=int(k[1].sum()), mean_sweeps=float(k[2].float().mean()))

    # K2's path: decode_int8 with its defaults (6 sweeps, b_tile 32, no early
    # stop), as decode_pallas_int8's callers call it, on the full cell's
    # decoder input; the counts are reset just before and read just after.
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    hard, ok, sweeps = dec.decode_int8(full, 1, 224, with_sweeps=True)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    check(launches.get(dec.KERNEL_INT8, 0) > 0, "K2's path launched no kernel")
    g = get_graph(1, 224)
    ms = cuda_ms(lambda: dec.decode_int8(full, 1, 224), 10)
    ms_es_tile32 = cuda_ms(lambda: dec.decode_int8(full, 1, 224, early_stop=True), 10)
    ms_es_tile1 = cuda_ms(lambda: dec.decode_int8(full, 1, 224, b_tile=1,
                                                  early_stop=True), 10)
    plain_ms = cuda_ms(lambda: dec.decode_int8_plain(full, 1, 224), 3, warmup=1)
    n_bytes = full.numel() + full.shape[0] * (g.kb * 224 + 1)
    total_sweeps = int(sweeps.sum())
    bound_ms, bound_by = kernel_bound(g, 224, total_sweeps, n_bytes)
    emit("kernel_int8_time", kernel=dec.KERNEL_INT8, codeblocks=full.shape[0],
         launches=launches, sweeps_total=total_sweeps, ok=int(ok.sum()),
         default_fixed_6_ms=ms, early_stop_tile32_ms=ms_es_tile32,
         early_stop_tile1_ms=ms_es_tile1, plain_default_ms=plain_ms,
         bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by)
    return dict(max_err=max_err, launches=launches.get(dec.KERNEL_INT8, 0), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    try:
        from srsran_edgeric_5g_tpu_torch import cuda_build
        from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder_cuda, encoder
        from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm
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
    fcx = phase_full_cell(fcm, sp, cuda_build, decoder_cuda, dev)
    k2 = phase_kernel_int8(decoder_cuda, encoder, cuda_build, dev,
                           fcx["decoder_input"])

    leaked = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or m == "srsran_edgeric_5g_tpu" or m.startswith("srsran_edgeric_5g_tpu.")]
    check(not leaked, f"JAX modules imported: {leaked[:5]}")

    # No PyTorch call computes a layered min-sum decode: library_ms is null.
    src = "srsran_edgeric_5g_tpu_torch/csrc/ldpc_layered.cu"
    kernels = [{
        "name": decoder_cuda.KERNEL, "route": "cuda", "source": src,
        "replaces": "srsran_edgeric_5g_tpu/ops/ldpc/decoder_pallas.py:211",
        "launches": fcx["launches"].get(decoder_cuda.KERNEL, 0),
        "max_abs_err": max_err, "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": None,
    }, {
        "name": decoder_cuda.KERNEL_INT8, "route": "cuda", "source": src,
        "replaces": "srsran_edgeric_5g_tpu/ops/ldpc/decoder_pallas.py:261",
        "launches": k2["launches"], "max_abs_err": k2["max_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None,
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
