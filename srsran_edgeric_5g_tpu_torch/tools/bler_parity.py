"""Decoder BLER parity on the port: identical noisy int8 LLR buffers through
the port's decode schedules.

Port of ``tools/bler_parity.py``'s own columns.  Per MCS operating point the
TX chain (segment -> LDPC encode -> rate match -> QAM -> AWGN -> the
reference's int8 demap -> rate dematch into the int8 N-domain buffer) feeds
the same buffers, in chunks of 512 codeblocks, to:

  * ``wire_auto``: the layered kernel's wire mode on the card (the
    reference's ``layered_rolls_wire``; ``layered_wire`` on the CPU);
  * ``layered_rolls_i8``: the reference's fixed-point arithmetic, plain;
  * ``auto``: the layered kernel's f32 mode on the card (the reference's
    ``layered_rolls_bf16`` column, a TPU formulation that the port refuses
    by name; ``layered`` on the CPU).

Each chunk stops once every codeword in it meets parity, as the JAX tool's
calls do.  The reference decoder's column (``native/refharness``, built from
the srsRAN sources) waits for those sources to be in the repository.  Block
= exact K-bit codeblock match, TB = all its codeblocks; 6 iterations,
``numpy.random.default_rng(1000 + mcs)``.

    python -m srsran_edgeric_5g_tpu_torch.tools.bler_parity [--blocks 1000]
        [--case N] [--schedules a,b] [--device cuda|cpu] [--out FILE.md]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops import modulation
from ..ops.ldpc import decoder, encoder, rate_match, segmenter
from ..ran import tbs as tbs_mod
from . import k1_launches, parser, write_record

# (mcs_idx, label, SNR grid): 0.25 dB steps around each waterfall.
CASES = [
    (4, "QPSK r0.30", np.arange(-1.75, 0.30, 0.25)),
    (15, "16QAM r0.60", np.arange(7.75, 10.05, 0.25)),
    (24, "64QAM r0.75", np.arange(15.25, 17.30, 0.25)),
]
SCHEDULES = ("wire_auto", "layered_rolls_i8", "auto")
NUM_ITERS = 6
CHUNK = 512
REFERENCE_COLUMN = "waits for the reference sources"


def build_point(mcs_idx: int, n_blocks: int, rng: np.random.Generator,
                nof_prb: int = 52, device: str | torch.device = "cuda"):
    """TX chain of one MCS up to the symbols: -> (McsConfig, TBS, segment
    plan, rate-match plan, (B*C, K) sent codeblocks as numpy, (B*C, E/Qm)
    complex64 symbols as numpy)."""
    dev = resolve_device(device)
    mcs = tbs_mod.mcs_config(mcs_idx, "qam64")
    nre = tbs_mod.nof_re(nof_prb, 12, 12)
    a = tbs_mod.tbs(nre, mcs.target_rate, mcs.qm)
    bg = segmenter.select_base_graph(a, mcs.target_rate)
    seg = segmenter.get_segment_plan(a, bg, nre * mcs.qm, mcs.qm)
    rm = rate_match.get_rate_match_plan(seg.bg, seg.zc, seg.e[0], 0, mcs.qm,
                                        seg.k_prime)
    payload = torch.as_tensor(rng.integers(0, 2, (n_blocks, a), dtype=np.int8),
                              device=dev)
    cbs = segmenter.segment_tb(payload, seg)            # (B*C, K)
    cw = encoder.encode(cbs, seg.bg, seg.zc)
    syms = modulation.modulate(rate_match.rate_match(cw, rm), mcs.modulation)
    return mcs, a, seg, rm, cbs.cpu().numpy(), syms.cpu().numpy()


def llr_buffer(rm, syms: np.ndarray, snr_db: float, rng: np.random.Generator,
               device: str | torch.device = "cuda") -> torch.Tensor:
    """AWGN + the reference's int8 demap + dematch -> int8 (B*C, cols*Zc) on
    ``device``.  E < N at these points, so the dematch only places values:
    the cast is exact, fillers saturate to +127 and the punctured systematic
    positions stay 0, the reference's rx_buffer domain."""
    dev = resolve_device(device)
    nv = 10 ** (-snr_db / 10)
    noise = rng.normal(size=syms.shape) + 1j * rng.normal(size=syms.shape)
    y = torch.as_tensor((syms + noise * np.sqrt(nv / 2)).astype(np.complex64),
                        device=dev)
    mod_name = {2: "qpsk", 4: "qam16", 6: "qam64"}[rm.qm]
    llr = modulation.demodulate_soft(y, torch.tensor(np.float32(nv)), mod_name)
    full = rate_match.rate_dematch(llr.to(torch.float32), rm)
    return torch.clamp(torch.round(full), -127, 127).to(torch.int8)


def decode_ours(buf: torch.Tensor, seg, iters: int, schedule: str,
                chunk: int = CHUNK) -> torch.Tensor:
    """Decode the int8 buffer in chunks of ``chunk`` codeblocks, each with
    its own batch exit as the JAX tool's calls (``exit_group``; one kernel
    call on the card) -> (B*C, K) hard bits.  The
    buffer is already in the reference's int8 wire domain (demap clip ±20 ->
    ±120): the integer schedules take it as int8, the f32 one as float32
    (min-sum is scale-invariant)."""
    x = buf if schedule in ("wire_auto", "layered_wire", "layered_rolls_i8") \
        else buf.to(torch.float32)
    return decoder.decode(x, seg.bg, seg.zc, num_iters=iters,
                          schedule=schedule, exit_group=chunk)[0]


def tb_bler(hards: torch.Tensor, tx_cbs: np.ndarray, c: int) -> float:
    ok_cb = (hards.cpu().numpy() == tx_cbs).all(axis=1)
    return 1.0 - float(ok_cb.reshape(-1, c).all(axis=1).mean())


def run_case(case_idx: int, n_blocks: int, schedules, device, lines: list[str],
             iters: int = NUM_ITERS) -> None:
    """One MCS case: every SNR point of its grid through every schedule."""
    mcs_idx, label, grid = CASES[case_idx]
    rng = np.random.default_rng(1000 + mcs_idx)
    _, a, seg, rm, tx_cbs, syms = build_point(mcs_idx, n_blocks, rng,
                                              device=device)
    hdr = (f"## MCS {mcs_idx} ({label}) — TBS {a}, C={seg.c}, Zc={seg.zc}, "
           f"BG{seg.bg}, E={rm.e}")
    print(hdr, flush=True)
    lines += [hdr, "", "| SNR (dB) | reference | " + " | ".join(schedules) + " |",
              "|---|---|" + "---|" * len(schedules)]
    for snr in grid:
        buf = llr_buffer(rm, syms, float(snr), rng, device)
        blers, launches = [], []
        for sch in schedules:
            n0 = k1_launches()
            blers.append(tb_bler(decode_ours(buf, seg, iters, sch), tx_cbs, seg.c))
            launches.append(k1_launches() - n0)
        lines.append(f"| {snr:+.2f} | {REFERENCE_COLUMN} | "
                     + " | ".join(f"{b:.4f}" for b in blers) + " |")
        print(f"  {snr:+.2f} dB: " + " ".join(
            f"{s}={b:.4f} (K1 launches {n})"
            for s, b, n in zip(schedules, blers, launches)), flush=True)
    lines.append("")


def main(argv=None) -> int:
    ap = parser("srsran_edgeric_5g_tpu_torch.tools.bler_parity", __doc__)
    ap.add_argument("--blocks", type=int, default=1000, help="TBs per point")
    ap.add_argument("--case", type=int, default=None,
                    help="one MCS case (index into CASES); all by default")
    ap.add_argument("--schedules", default=",".join(SCHEDULES))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    schedules = args.schedules.split(",")
    lines = [
        "# BLER decoder parity of the port's decode schedules", "",
        f"Identical noisy int8 LLR realizations (reference demap quantization, "
        f"clip ±20 -> ±120; 52 PRB 12-symbol allocation, AWGN) into the port's "
        f"schedules; {NUM_ITERS} iterations, alpha 0.8; {args.blocks} "
        f"TBs/point; block = exact K-bit codeblock match, TB = all its "
        f"codeblocks; decoded on {dev.type} "
        f"(srsran_edgeric_5g_tpu_torch/tools/bler_parity.py).  The reference "
        f"decoder's column {REFERENCE_COLUMN} (native/refharness).", ""]
    cases = range(len(CASES)) if args.case is None else [args.case]
    for i in cases:
        run_case(i, args.blocks, schedules, dev, lines)
    write_record(args.out, lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
