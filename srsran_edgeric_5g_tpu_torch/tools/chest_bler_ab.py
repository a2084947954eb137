"""End-to-end BLER through both channel estimators on the port.

Port of ``tools/chest_bler_ab.py``'s own columns (the record is
``CHEST_BLER_R2.md``): TB error rate of the complete PUSCH receive chain on
identical noisy received grids through a frequency-selective channel with
CFO, for

  * the receiver with the default estimator (``estimate_port``: LS + CFO +
    time average + linear interpolation; ``delay_spread_s=None``),
  * the receiver with the TA + smoothing estimator (``estimate_port_ta``,
    at 1.5 x the channel's delay spread).

The reference receiver's column (``native/refharness puschproc``, built from
the srsRAN sources) waits for those sources to be in the repository.
Channel: 2 taps (1 + 0.4 at +200 ns, the first delayed 100 ns) and 200 Hz
CFO; MCS 15 and 24 at 52 PRB with DM-RS on symbols 2 and 11.  Payloads and
noise come from ``numpy.random.default_rng(77 + mcs)`` in the JAX tool's
order, so the grids are the tool's.  Each grid's front is
``pusch.process``'s; the decode takes a point's stacked codeblocks in one
call, each TB stopping on its own (the reference's exit under its
``vmap``).

    python -m srsran_edgeric_5g_tpu_torch.tools.chest_bler_ab [--blocks 200]
        [--device cuda|cpu] [--out FILE.md]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..device import resolve_device
from ..models import pdsch, pusch
from ..ran import numerology as num
from ..ran import tbs as tbs_mod
from . import k1_launches, parser, receive, write_record

NPRB = 52
TAU0_S = 100e-9
ECHO_S = 200e-9
ECHO_A = 0.4
CFO_HZ = 200.0
TA_DELAY_SPREAD_S = 1.5 * (TAU0_S + ECHO_S)
REFERENCE_COLUMN = "waits for the reference sources"

# (mcs_idx, label, SNR grid): the fading channel shifts each AWGN waterfall
# right by about the fade margin.
CASES = [
    (15, "16QAM r0.60", np.arange(9.5, 12.05, 0.25)),
    (24, "64QAM r0.75", np.arange(16.75, 19.30, 0.25)),
]


def make_cfg(mcs_idx: int):
    """-> (PdschConfig, McsConfig, TBS) of the A/B's PUSCH."""
    mcs = tbs_mod.mcs_config(mcs_idx, "qam64")
    nre = tbs_mod.nof_re(NPRB, 12, 24)   # 12 symbols, 2 DM-RS
    a = tbs_mod.tbs(nre, mcs.target_rate, mcs.qm)
    cfg = pdsch.PdschConfig(
        rnti=0x4601, nof_prb=NPRB, start_prb=0, first_symbol=2,
        nof_symbols=12, dmrs_symbols=(2, 11),
        modulation=mcs.modulation, n_id=1, tbs=a,
        target_rate=mcs.target_rate)
    return cfg, mcs, a


def channel_response(nsubc: int, nsymb: int, symbol_times, scs_hz: float = 15e3
                     ) -> np.ndarray:
    """(nsymb, nsubc) complex64: 2-tap frequency response x CFO rotation."""
    k = np.arange(nsubc)
    h = (np.exp(-2j * np.pi * scs_hz * k * TAU0_S)
         + ECHO_A * np.exp(-2j * np.pi * scs_hz * k * (TAU0_S + ECHO_S)))
    rot = np.exp(2j * np.pi * CFO_HZ * np.asarray(symbol_times))
    return (rot[:, None] * h[None, :]).astype(np.complex64)


class Case:
    """One MCS of the A/B: the clean received grids of its TBs and the draws
    that follow, point after point."""

    def __init__(self, mcs_idx: int, n_blocks: int,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg, self.mcs, self.tbs = make_cfg(mcs_idx)
        self.timing = num.slot_timing(**num.CELL_10MHZ)
        nsubc = NPRB * 12
        self.times = np.asarray(self.timing.cp.data_starts)[:14] / self.timing.srate
        hgrid = channel_response(nsubc, 14, self.times)
        self.rng = np.random.default_rng(77 + mcs_idx)
        payloads = self.rng.integers(0, 2, (n_blocks, self.tbs), dtype=np.int8)
        self.payloads = torch.as_tensor(payloads, device=self.device)
        grids = torch.stack([pusch.transmit(p[None], self.cfg, 14, nsubc)
                             for p in self.payloads])
        self.clean = grids.cpu().numpy() * hgrid[None]
        self.sig = float(np.mean(np.abs(self.clean[self.clean != 0]) ** 2))

    def grids(self, snr_db: float) -> torch.Tensor:
        """The next point's noisy grids (B, 14, 624) on the case's device."""
        sigma = np.sqrt(self.sig * 10 ** (-snr_db / 10) / 2)
        noise = (self.rng.normal(size=self.clean.shape)
                 + 1j * self.rng.normal(size=self.clean.shape)) * sigma
        return torch.as_tensor((self.clean + noise).astype(np.complex64),
                               device=self.device)

    def rx(self, grids: torch.Tensor, delay_spread_s: float | None):
        """Both receivers' chain on ``grids``: -> (tb_ok (B,), decoder input)."""
        _, ok, llrs = receive(grids, self.cfg, self.timing.srate, self.times,
                              delay_spread_s)
        return ok, llrs


def run_case(mcs_idx: int, label: str, grid_snrs, n_blocks: int, device,
             lines: list[str]) -> None:
    case = Case(mcs_idx, n_blocks, device)
    hdr = (f"## MCS {mcs_idx} ({label}) — TBS {case.tbs}, {NPRB} PRB, 2-tap "
           f"(echo {ECHO_A} @ +{ECHO_S * 1e9:.0f} ns), CFO {CFO_HZ:.0f} Hz")
    print(hdr, flush=True)
    lines += [hdr, "",
              "| SNR (dB) | reference receiver | ours (default est) | "
              "ours (TA+smoothing est) |", "|---|---|---|---|"]
    for snr in grid_snrs:
        g = case.grids(float(snr))
        n0 = k1_launches()
        ok_def, _ = case.rx(g, None)
        ok_ta, _ = case.rx(g, TA_DELAY_SPREAD_S)
        b_def, b_ta = (1.0 - float(ok.float().mean()) for ok in (ok_def, ok_ta))
        lines.append(f"| {snr:+.2f} | {REFERENCE_COLUMN} | {b_def:.4f} | {b_ta:.4f} |")
        print(f"  {snr:+.2f} dB: def {b_def:.4f} ({int((~ok_def).sum())} TBs) "
              f"ta {b_ta:.4f} ({int((~ok_ta).sum())} TBs), K1 launches "
              f"{k1_launches() - n0}", flush=True)
    lines.append("")


def main(argv=None) -> int:
    ap = parser("srsran_edgeric_5g_tpu_torch.tools.chest_bler_ab", __doc__)
    ap.add_argument("--blocks", type=int, default=200, help="TBs per point")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    lines = [
        "# End-to-end BLER through both channel estimators (the port)", "",
        f"Identical noisy received grids ({args.blocks} TBs/point) into the "
        f"port's receiver with the default and the TA+smoothing estimators; "
        f"2-tap channel + {CFO_HZ:.0f} Hz CFO; decoded on {dev.type} "
        f"(srsran_edgeric_5g_tpu_torch/tools/chest_bler_ab.py).  The reference "
        f"receiver's column {REFERENCE_COLUMN} (native/refharness).", ""]
    for mcs_idx, label, grid_snrs in CASES:
        run_case(mcs_idx, label, grid_snrs, args.blocks, dev, lines)
    write_record(args.out, lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
