"""Per-stage throughput of the port: one line per stage, ms per call and
millions of elements per second.

Port of ``tools/kernel_bench.py``, with its shapes and its chained data
dependency (each call's input carries a data-dependent zero from the one
before).  On the card each stage is timed with CUDA events over ``--iters``
calls after one warm call; on the CPU with the host clock.  The LDPC decode
lines are the layered kernel (K1) at BG1 Zc = 384, B = 64, 6.5 dB: through
``decode("auto")`` (f32 mode, the reference's batch early exit) in place of
the reference's XLA ``layered_rolls`` line, and at a fixed 6 sweeps
(``decode("pallas")``) in place of its TPU-only Pallas line.

    python -m srsran_edgeric_5g_tpu_torch.tools.kernel_bench [--iters 20]
        [--device cuda|cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import channel_est, equalizer, modulation, prach
from ..ops.ldpc import decoder, encoder
from ..ops.ldpc.graph import get_graph
from . import parser, write_record


def chained(fn, x0, iters: int, device: torch.device) -> float:
    """Seconds per call of ``fn: (x, eps) -> (out, eps')``, ``eps`` a
    data-dependent zero folded into the next call's input."""
    out, eps = fn(x0, torch.zeros((), device=device))
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out, eps = fn(x0, eps)
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out, eps = fn(x0, eps)
    return (time.perf_counter() - t0) / iters


def report(name: str, elems: int, dt: float, unit: str) -> dict:
    print(f"{name:28s} {dt * 1e3:9.4f} ms   {elems / dt / 1e6:10.1f} M{unit}/s",
          flush=True)
    return dict(stage=name, ms=dt * 1e3, m_per_s=elems / dt / 1e6, unit=unit)


def _cn(rng, shape, dev) -> torch.Tensor:
    return torch.as_tensor((rng.normal(size=shape) + 1j * rng.normal(size=shape))
                           .astype(np.complex64), device=dev)


def decode_llrs(rng: np.random.Generator, dev: torch.device):
    """The decode lines' input: 64 BG1 Zc = 384 codewords, BPSK at 6.5 dB,
    LLRs clipped to ±120, the 2 Zc punctured columns 0 -> (messages,
    float32 LLRs)."""
    g = get_graph(1, 384)
    msgs = torch.as_tensor(rng.integers(0, 2, (64, g.k), dtype=np.int8), device=dev)
    cw = encoder.encode(msgs, 1, 384).cpu().numpy()
    sym = 1 - 2 * cw.astype(np.float32)
    sigma = 10 ** (-6.5 / 20)
    y = sym + rng.normal(size=sym.shape) * sigma
    llr = np.clip(2 * y / sigma ** 2, -120, 120)
    llr[:, :2 * 384] = 0.0
    return msgs, torch.as_tensor(llr.astype(np.float32), device=dev)


def run(iters: int = 20, device: str | torch.device = "cuda") -> list[dict]:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = []

    # DFT (OFDM-sized batched FFT): 1536-pt x 14 symbols x 16 slots.
    x = _cn(rng, (224, 1536), dev)

    def fft(v, e):
        o = torch.fft.fft(v + e)
        return o, o[0, 0].real * 0
    rows.append(report("fft_1536_batch224", x.numel(), chained(fft, x, iters, dev),
                       "samp"))

    # LDPC encode: BG1 Zc=384, B=64.
    g = get_graph(1, 384)
    msgs, llr = decode_llrs(rng, dev)

    def enc(m, e):
        o = encoder.encode(torch.bitwise_xor(m, e.to(torch.int8)), 1, 384)
        return o, (o[0, 0] & 0).to(torch.float32)
    rows.append(report("ldpc_enc_bg1_zc384_b64", 64 * g.k,
                       chained(enc, msgs, iters, dev), "bit"))

    # LDPC decode: K1 f32 with the batch early exit, and at 6 fixed sweeps.
    for name, schedule in (("ldpc_dec_auto_es_b64", "auto"),
                           ("ldpc_dec_k1_fixed6_b64", "pallas")):
        def dec(v, e, schedule=schedule):
            o = decoder.decode(v + e, 1, 384, schedule=schedule)[0]
            return o, (o[0, 0] & 0).to(torch.float32)
        rows.append(report(name, 64 * g.kb * 384,
                           chained(dec, llr, max(1, iters // 4), dev), "bit"))

    # Modulation map + soft demap (64QAM).
    bits = torch.as_tensor(rng.integers(0, 2, (16, 99072), dtype=np.int8), device=dev)

    def mod(b, e):
        o = modulation.modulate(torch.bitwise_xor(b, e.to(torch.int8)), "qam64")
        return o, o[0, 0].real * 0
    rows.append(report("qam64_map", bits.numel(), chained(mod, bits, iters, dev), "bit"))
    syms = _cn(rng, (16, 16512), dev) * np.float32(0.3)
    nv = torch.tensor(0.05, device=dev)

    def dem(s, e):
        o = modulation.demodulate_soft(s + e, nv, "qam64")
        return o, (o[0, 0] & 0).to(torch.float32)
    rows.append(report("qam64_softdemap", syms.numel(), chained(dem, syms, iters, dev),
                       "symb"))

    # MMSE 1xN equalizer over a 20 MHz 4-UE slot batch.
    shp = (64, 12, 312)
    yv, hv = _cn(rng, shp, dev), _cn(rng, shp, dev)

    def eq(v, e):
        o = equalizer.equalize_mmse_1xn((v + e)[None], hv[None], nv)[0]
        return o, o[0, 0, 0].real * 0
    rows.append(report("mmse_1x1_eq", yv.numel(), chained(eq, yv, iters, dev), "RE"))

    # Channel estimate (LS + CFO + interp), 64 single-symbol-pair UEs.
    npil, width = 156, 312
    sc = np.arange(0, 2 * npil, 2).astype(np.int32)
    rx = _cn(rng, (64, 2, npil), dev)
    ref = torch.ones((64, 2, npil), dtype=torch.complex64, device=dev)

    def ce(v, e):
        o = channel_est.estimate_port(v + e, ref, sc, width,
                                      dmrs_symbol_times_s=np.r_[0.0, 5e-4])[0]
        return o, o[0, 0].real * 0
    rows.append(report("chest_64ue", 64 * width, chained(ce, rx, iters, dev), "RE"))

    # PRACH detect (64-preamble bank).
    pcfg = prach.PrachConfig(root_sequence_index=0, zero_correlation_zone=13)
    fd = prach.generate(pcfg, 7, device=dev)

    def det(v, e):
        o = prach.detect(v + e, pcfg).metrics
        return o, o[0].real * 0
    rows.append(report("prach_detect_64pre", 64 * 839, chained(det, fd, iters, dev),
                       "corr"))
    return rows


def main(argv=None) -> int:
    ap = parser("srsran_edgeric_5g_tpu_torch.tools.kernel_bench", __doc__)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev.type}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""),
          flush=True)
    rows = run(args.iters, dev)
    write_record(args.out, [f"{r['stage']:28s} {r['ms']:9.4f} ms   "
                            f"{r['m_per_s']:10.1f} M{r['unit']}/s" for r in rows])
    return 0


if __name__ == "__main__":
    sys.exit(main())
