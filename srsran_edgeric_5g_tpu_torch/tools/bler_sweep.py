"""BLER vs SNR sweep of the full coded chain per MCS on the port.

Port of ``tools/bler_sweep.py`` (which wrote ``BLER_R1.md``): segment ->
LDPC encode -> rate match -> QAM -> AWGN -> int8 demap -> dematch ->
``decode(num_iters=8)`` -> TB CRC, 52 PRB, 12 symbols, 64 TBs per point.
The decode is the default schedule, ``"auto"``: on the card the layered
kernel's f32 mode, on the CPU ``"layered"``, both with the reference's
batch exit over the point's codeblocks.  Payload and noise come from
``numpy.random.default_rng(0)`` in the JAX tool's order (payload, real
noise, imaginary noise, point after point), so the card sees the
realisations behind ``BLER_R1.md``.

    python -m srsran_edgeric_5g_tpu_torch.tools.bler_sweep [--blocks 64]
        [--device cuda|cpu] [--out FILE.md]
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops import modulation
from ..ops.ldpc import decoder, encoder, rate_match, segmenter
from ..ran import tbs as tbs_mod
from . import k1_launches, parser, write_record

CASES = {
    4: [-1.0, 0.0, 1.0, 2.0, 3.0],        # QPSK r~0.3
    15: [5.0, 6.0, 7.0, 8.0, 9.0],        # 16QAM r~0.6
    24: [14.0, 15.0, 16.0, 17.0, 18.0],   # 64QAM r~0.75
}
NUM_ITERS = 8
SEED = 0


@dataclasses.dataclass
class Point:
    mcs_idx: int
    snr_db: float
    tbs: int
    modulation: str
    rate: float
    seg: segmenter.SegmentPlan
    llrs: torch.Tensor       # (B*C, cols*Zc) float32 decoder input
    hard: torch.Tensor       # (B*C, K) int8 decoded messages
    cb_ok: torch.Tensor      # (B*C,) parity
    tb_ok: torch.Tensor      # (B,) TB CRC

    @property
    def bler(self) -> float:
        return 1.0 - float(self.tb_ok.float().mean())


def _plan(mcs_idx: int, nof_prb: int = 52):
    """(McsConfig, segment plan, TBS) of one MCS on ``nof_prb`` PRB."""
    mcs = tbs_mod.mcs_config(mcs_idx, "qam64")
    nre = tbs_mod.nof_re(nof_prb, 12, 12)
    a = tbs_mod.tbs(nre, mcs.target_rate, mcs.qm)
    bg = segmenter.select_base_graph(a, mcs.target_rate)
    return mcs, segmenter.get_segment_plan(a, bg, nre * mcs.qm, mcs.qm), a


def decoder_input(mcs_idx: int, snr_db: float, n_blocks: int,
                  rng: np.random.Generator, nof_prb: int = 52,
                  device: str | torch.device = "cuda"):
    """The chain up to the decoder for one (MCS, SNR) point, drawing from
    ``rng``: -> (segment plan, McsConfig, (B*C, cols*Zc) float32 LLRs)."""
    dev = resolve_device(device)
    mcs, seg, a = _plan(mcs_idx, nof_prb)
    rm = rate_match.get_rate_match_plan(seg.bg, seg.zc, seg.e[0], 0, mcs.qm,
                                        seg.k_prime)
    payload = torch.as_tensor(rng.integers(0, 2, (n_blocks, a), dtype=np.int8),
                              device=dev)
    cw = encoder.encode(segmenter.segment_tb(payload, seg), seg.bg, seg.zc)
    syms = modulation.modulate(rate_match.rate_match(cw, rm),
                               mcs.modulation).cpu().numpy()
    nv = 10 ** (-snr_db / 10)
    noise = rng.normal(size=syms.shape) + 1j * rng.normal(size=syms.shape)
    y = torch.as_tensor((syms + noise * np.sqrt(nv / 2)).astype(np.complex64),
                        device=dev)
    # int8 wire-format LLRs, as the reference's demapper gives them.
    llr = modulation.demodulate_soft(y, torch.tensor(np.float32(nv)),
                                     mcs.modulation).to(torch.float32)
    return seg, mcs, rate_match.rate_dematch(llr.reshape(-1, rm.e), rm)


def point_input(mcs_idx: int, snr_db: float, n_blocks: int = 64,
                device: str | torch.device = "cuda"):
    """``decoder_input`` of one point of the sweep with the realisations
    ``main`` gives it: default_rng(SEED), every earlier point's draws made
    first (without running their chains)."""
    rng = np.random.default_rng(SEED)
    for m, snrs in CASES.items():
        for snr in snrs:
            if (m, snr) == (mcs_idx, snr_db):
                return decoder_input(m, snr, n_blocks, rng, device=device)
            mcs, seg, a = _plan(m)
            rng.integers(0, 2, (n_blocks, a), dtype=np.int8)
            shape = (n_blocks * seg.c, seg.e[0] // mcs.qm)
            rng.normal(size=shape)
            rng.normal(size=shape)
    raise ValueError(f"no point MCS {mcs_idx} at {snr_db} dB in the sweep")


def run_point(mcs_idx: int, snr_db: float, n_blocks: int,
              rng: np.random.Generator, nof_prb: int = 52,
              device: str | torch.device = "cuda",
              num_iters: int = NUM_ITERS) -> Point:
    """One (MCS, SNR) point of the sweep, drawing from ``rng``."""
    seg, mcs, full = decoder_input(mcs_idx, snr_db, n_blocks, rng, nof_prb,
                                   device)
    hard, cb_ok = decoder.decode(full, seg.bg, seg.zc, num_iters=num_iters)
    _, tb_ok = segmenter.desegment_tb(hard, seg)
    return Point(mcs_idx=mcs_idx, snr_db=snr_db, tbs=seg.a,
                 modulation=mcs.modulation, rate=mcs.target_rate, seg=seg,
                 llrs=full, hard=hard, cb_ok=cb_ok, tb_ok=tb_ok)


def table(rows: list[tuple[int, list[Point]]], n_blocks: int,
          device: torch.device) -> list[str]:
    """The markdown record in ``BLER_R1.md``'s layout."""
    where = ("the layered kernel's f32 mode on the card" if device.type == "cuda"
             else "the plain layered decoder on the CPU")
    lines = [f"# BLER vs SNR (full coded chain, int8 LLR wire, {NUM_ITERS} "
             f"iterations,",
             f"# 52 PRB 12-symbol allocation, AWGN, {n_blocks} TBs/point; "
             f"decoded by {where})", "",
             "| MCS | mod | rate | TBS | " +
             " | ".join(f"{s:+.0f} dB" for s in list(CASES.values())[0]) + " |",
             "|---|---|---|---|" + "---|" * 5]
    for mcs_idx, pts in rows:
        p = pts[0]
        lines.append(f"| {mcs_idx} | {p.modulation} | {p.rate:.2f} | {p.tbs} | "
                     + " | ".join(f"{q.bler:.3f}" for q in pts) + " |")
    lines += ["", "SNR columns per row correspond to that row's sweep range "
              "(QPSK -1..3, 16QAM 5..9, 64QAM 14..18 dB)."]
    return lines


def main(argv=None) -> int:
    ap = parser("srsran_edgeric_5g_tpu_torch.tools.bler_sweep", __doc__)
    ap.add_argument("--blocks", type=int, default=64, help="TBs per point")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(SEED)
    rows = []
    for mcs_idx, snrs in CASES.items():
        pts = []
        for snr in snrs:
            n0 = k1_launches()
            p = run_point(mcs_idx, snr, args.blocks, rng, device=dev)
            fails = int((~p.tb_ok).sum())
            print(f"MCS{mcs_idx} snr={snr:+.1f}: BLER {p.bler:.3f} "
                  f"({fails}/{args.blocks} TBs failed, {p.llrs.shape[0]} "
                  f"codeblocks, K1 launches {k1_launches() - n0})", flush=True)
            p.llrs = p.hard = None     # the record keeps the outcomes only
            pts.append(p)
        rows.append((mcs_idx, pts))
        if pts[-1].bler > pts[0].bler:
            print(f"MCS{mcs_idx}: the waterfall rises with SNR", file=sys.stderr)
            return 1
    write_record(args.out, table(rows, args.blocks, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
