"""BLER of the full PUSCH receive chain through the channel-emulator
profiles (AWGN, HST Doppler, TDL Rayleigh fading) and the RLF outage run,
on the port.

Port of ``tools/bler_channel_sweep.py`` (which wrote
``BLER_CHANNELS_R4.md``).  Per (profile, SNR) point: B independent slots of
payload -> ``pusch.transmit`` -> OFDM -> channel -> OFDM demod -> chest
(+CFO) -> MMSE -> demap -> dematch -> ``decode("wire_auto")`` (6 sweeps) ->
TB CRC, each slot with its own fading realisation; 10 MHz, 24 PRB 16QAM
r0.4 (TBS 4608).  Each slot's front is ``pusch.process``'s; the decode takes
the point's stacked codeblocks in one call (one launch of the layered kernel
on the card: what the reference's ``vmap`` of one slot's receive batches
to), each TB stopping on its own, as under ``vmap``.  Payloads come
from ``numpy.random.default_rng(7)`` in the JAX tool's order; noise and TDL
taps from ``torch.Generator``s, since the reference's ``jax.random``
realisations cannot be reproduced, so points are held to the record's BLER
statistically.

    python -m srsran_edgeric_5g_tpu_torch.tools.bler_channel_sweep
        [--blocks 200] [--device cuda|cpu] [--out FILE.md]
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..models import pdsch, pusch
from ..ops import channel_model as chm
from ..ops import ofdm
from ..ran import numerology as num
from . import k1_launches, parser, receive, write_record

PROFILES = [
    # (name, snr grid): AWGN/HST grids straddle the coded waterfall;
    # Rayleigh (TDL, flat per-slot realisation, no diversity) has the
    # shallow 1/SNR outage slope, so its grid is wide.
    ("awgn", [-2.0, -1.0, 0.0, 1.0, 2.0]),
    ("hst600", [-2.0, -1.0, 0.0, 1.0, 2.0]),
    ("tdla", [2.0, 5.0, 10.0, 15.0, 20.0]),
    ("tdlc", [2.0, 5.0, 10.0, 15.0, 20.0]),
]
HST_FD_HZ, HST_PERIOD_S = 600.0, 7.2
RLF_SLOTS, RLF_ON_MS, RLF_OFF_MS, RLF_SNR_DB = 20, 3, 2, 25.0
RLF_DUTY = RLF_ON_MS / (RLF_ON_MS + RLF_OFF_MS)
SEED = 7


@dataclasses.dataclass(frozen=True)
class Setup:
    """The sweep's cell and UE on one device."""

    timing: num.SlotTiming
    cfg: pdsch.PdschConfig
    times: np.ndarray
    device: torch.device

    @property
    def tbs(self) -> int:
        return self.cfg.derived_tbs()


def setup(device: str | torch.device = "cuda") -> Setup:
    t = num.slot_timing(**num.CELL_10MHZ)
    cfg = pdsch.PdschConfig(rnti=0x11, nof_prb=24, start_prb=4,
                            modulation="qam16", target_rate=0.4)
    return Setup(timing=t, cfg=cfg, times=np.asarray(t.cp.data_starts) / t.srate,
                 device=resolve_device(device))


def transmit(payloads: np.ndarray, su: Setup) -> torch.Tensor:
    """(B, TBS) payload bits -> (B, total) time-domain slots."""
    t = su.timing
    grids = torch.stack([pusch.transmit(torch.as_tensor(p[None], device=su.device),
                                        su.cfg, t.nsymb, t.nof_subc)
                         for p in payloads])
    return ofdm.modulate_slot(grids, t, scale=1.0 / t.nfft)


def channel(td: torch.Tensor, profile: str, snr_db: float, gen: torch.Generator,
            su: Setup) -> torch.Tensor:
    """One profile over a (B, total) slot batch: AWGN at ``snr_db`` of the
    batch's mean power after the fading; HST at the trajectory's worst
    sustained point (slot 0 at its start, +fd); TDL one Rayleigh realisation
    per slot."""
    srate = su.timing.srate
    if profile == "hst600":
        td = chm.apply_hst(td, fd_hz=HST_FD_HZ, period_s=HST_PERIOD_S, srate=srate)
    elif profile in chm.TDL_PROFILES:
        ch = chm.make_tdl(profile, srate)
        h = torch.stack([chm.tdl_coefficients(gen, ch, su.device)
                         for _ in range(td.shape[0])])
        td = chm.apply_tdl(td, ch, h)
    elif profile != "awgn":
        raise ValueError(f"unknown profile {profile!r}")
    return chm.awgn(gen, td, snr_db)


def delay_spread(profile: str, su: Setup) -> float | None:
    """The TDL points' receivers use the TA + smoothing estimator at the
    profile's delay spread; the others the default estimator."""
    if profile not in chm.TDL_PROFILES:
        return None
    return chm.make_tdl(profile, su.timing.srate).max_delay / su.timing.srate


def rx(rx_td: torch.Tensor, su: Setup, delay_spread_s: float | None):
    """OFDM demod + ``pusch.process`` over the batch, stacked decode:
    -> (payload (B, TBS), tb_ok (B,), decoder input)."""
    grids = ofdm.demodulate_slot(rx_td, su.timing, scale=1.0)
    return receive(grids, su.cfg, su.timing.srate, su.times, delay_spread_s)


def run_point(profile: str, snr_db: float, payloads: np.ndarray,
              gen: torch.Generator, su: Setup):
    """One (profile, SNR) point: -> (tb_ok (B,), decoder input)."""
    td = channel(transmit(payloads, su), profile, snr_db, gen, su)
    _, ok, llrs = rx(td, su, delay_spread(profile, su))
    return ok, llrs


def rlf_run(payloads: np.ndarray, gen: torch.Generator, su: Setup):
    """RLF outage: slot blanking 3 ms on / 2 ms off at 25 dB -> (tb_ok,
    decoder input); the decoded share is the duty cycle exactly."""
    td = chm.apply_rlf(transmit(payloads, su), t_on_ms=RLF_ON_MS,
                       t_off_ms=RLF_OFF_MS)
    _, ok, llrs = rx(chm.awgn(gen, td, RLF_SNR_DB), su, None)
    return ok, llrs


def main(argv=None) -> int:
    ap = parser("srsran_edgeric_5g_tpu_torch.tools.bler_channel_sweep", __doc__)
    ap.add_argument("--blocks", type=int, default=200, help="TBs per point")
    args = ap.parse_args(argv)
    su = setup(args.device)
    rng = np.random.default_rng(SEED)
    rows = []
    for i, (prof, grid) in enumerate(PROFILES):
        blers = []
        for j, snr in enumerate(grid):
            payloads = rng.integers(0, 2, (args.blocks, su.tbs), dtype=np.int8)
            gen = torch.Generator(device=su.device).manual_seed(
                SEED * 1000 + 10 * i + j)
            n0 = k1_launches()
            ok, _ = run_point(prof, snr, payloads, gen, su)
            blers.append(1.0 - float(ok.float().mean()))
            print(f"{prof} {snr:+.1f} dB: BLER {blers[-1]:.3f} "
                  f"({int((~ok).sum())}/{args.blocks} TBs failed, K1 launches "
                  f"{k1_launches() - n0})", flush=True)
        rows.append((prof, grid, blers))

    payloads = rng.integers(0, 2, (RLF_SLOTS, su.tbs), dtype=np.int8)
    ok, _ = rlf_run(payloads, torch.Generator(device=su.device).manual_seed(3), su)
    share = int(ok.sum()) / RLF_SLOTS
    print(f"RLF ({RLF_ON_MS} ms on / {RLF_OFF_MS} ms off, {RLF_SNR_DB:g} dB): "
          f"{int(ok.sum())}/{RLF_SLOTS} slots decoded = {share:.2f}", flush=True)

    lines = [
        "# PUSCH BLER through the channel-emulator profiles (the port)", "",
        f"Full receive chain (chest+CFO -> MMSE -> max-log demap -> layered "
        f"min-sum x6 -> TB CRC), 24 PRB 16QAM r0.4 (TBS {su.tbs}), "
        f"{args.blocks} TBs/point, independent Rayleigh realisation per slot "
        f"for TDL; HST = 600 Hz Doppler at the trajectory's worst sustained "
        f"point; decoded on {su.device.type} "
        f"(srsran_edgeric_5g_tpu_torch/tools/bler_channel_sweep.py).", "",
        "| profile | " + " | ".join("BLER @ SNR" for _ in range(5)) + " |",
        "|---|" + "---|" * 5]
    for prof, grid, blers in rows:
        lines.append("| " + prof + " | " + " | ".join(
            f"{b:.3f} @ {s:g} dB" for s, b in zip(grid, blers)) + " |")
    lines += ["", f"RLF ({RLF_ON_MS} ms on / {RLF_OFF_MS} ms off, "
              f"{RLF_SNR_DB:g} dB): {int(ok.sum())}/{RLF_SLOTS} slots decoded = "
              f"{share:.2f} (duty cycle {RLF_DUTY:.2f}).", ""]
    write_record(args.out, lines)
    if int(ok.sum()) != round(RLF_DUTY * RLF_SLOTS):
        print(f"RLF decoded share {share} is not the duty cycle {RLF_DUTY}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
