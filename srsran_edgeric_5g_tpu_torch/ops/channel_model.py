"""Channel emulator: AWGN, CFO, delay, TDL Rayleigh fading, HST and RLF.

Port of ``srsran_edgeric_5g_tpu/ops/channel_model.py`` (the reference UE
tree's channel emulator, srs-4G-UE/lib/src/phy/channel/{ch_awgn,delay,
fading,hst,rlf}.c), used to stress the receive chain:

  * awgn: complex Gaussian at a target SNR;
  * cfo / delay: frequency shift and integer sample delay;
  * TDL fading: a tapped delay line with per-tap Rayleigh coefficients,
    applied as a sparse FIR over the static tap set, with TDL-A/B/C-style
    power/delay profiles at a given sample rate;
  * HST: the high-speed-train Doppler trajectory; RLF: periodic blanking.

A ``torch.Generator`` takes the place of the reference's JAX key; the two
give different numbers from one seed, so the random functions are held to
their stated statistics, not to the reference's draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Simplified power-delay profiles (delay ns, power dB): 3GPP TR 38.901 TDL
# shapes truncated to the strongest taps.
TDL_PROFILES = {
    "tdla": ((0.0, 0.0), (38.2, -11.2), (60.3, -19.0), (94.0, -22.8)),
    "tdlb": ((0.0, 0.0), (107.0, -2.2), (251.0, -4.0), (426.0, -8.0)),
    "tdlc": ((0.0, -4.4), (209.0, -1.2), (423.0, -3.5), (658.0, 0.0),
             (1029.0, -5.6)),
}


def _cn(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Complex Gaussian with unit-variance real and imaginary parts."""
    re = torch.randn(shape, generator=generator, device=device)
    im = torch.randn(shape, generator=generator, device=device)
    return torch.complex(re, im)


def awgn(generator: torch.Generator, samples: torch.Tensor,
         snr_db: float) -> torch.Tensor:
    """Add complex AWGN at the given SNR w.r.t. the measured signal power."""
    p = torch.mean(torch.abs(samples) ** 2)
    nv = p * 10.0 ** (-snr_db / 10.0)
    noise = _cn(generator, samples.shape, samples.device)
    return samples + noise.to(samples.dtype) * torch.sqrt(nv / 2)


def apply_cfo(samples: torch.Tensor, cfo_hz: float, srate: float) -> torch.Tensor:
    """Rotate by e^{j 2 pi cfo n / srate} (float32 phase, as the reference)."""
    n = samples.shape[-1]
    ph = float(np.float32(2.0 * np.pi * cfo_hz / srate)) * torch.arange(
        n, dtype=torch.float32, device=samples.device)
    return samples * torch.complex(torch.cos(ph), torch.sin(ph))


def apply_delay(samples: torch.Tensor, delay_samples: int) -> torch.Tensor:
    """Integer-sample delay (zero-filled head)."""
    if delay_samples == 0:
        return samples
    pad = samples.new_zeros((*samples.shape[:-1], delay_samples))
    return torch.cat([pad, samples[..., :-delay_samples]], dim=-1)


@dataclasses.dataclass(frozen=True, eq=False)
class TdlChannel:
    """Static tap layout for a profile at a sample rate."""

    taps: np.ndarray       # (ntap,) integer sample delays
    powers: np.ndarray     # (ntap,) linear power, sum = 1

    @property
    def max_delay(self) -> int:
        return int(self.taps.max())


def make_tdl(profile: str, srate: float, delay_spread_scale: float = 1.0
             ) -> TdlChannel:
    prof = TDL_PROFILES[profile]
    delays = np.asarray([int(round(d * 1e-9 * delay_spread_scale * srate))
                         for d, _ in prof])
    powers = 10.0 ** (np.asarray([p for _, p in prof]) / 10.0)
    # Merge taps landing on the same sample.
    uniq = {}
    for d, p in zip(delays, powers):
        uniq[d] = uniq.get(d, 0.0) + p
    taps = np.asarray(sorted(uniq))
    pw = np.asarray([uniq[t] for t in taps])
    pw = pw / pw.sum()
    return TdlChannel(taps=taps, powers=pw)


def tdl_coefficients(generator: torch.Generator, ch: TdlChannel,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """One Rayleigh realisation per tap: h_i ~ CN(0, p_i), complex64."""
    h = _cn(generator, (len(ch.taps),), device)
    scale = torch.as_tensor(np.sqrt(ch.powers / 2.0), dtype=torch.float32,
                            device=device)
    return (h * scale).to(torch.complex64)


def apply_tdl(samples: torch.Tensor, ch: TdlChannel,
              coeffs: torch.Tensor) -> torch.Tensor:
    """y[n] = sum_i h_i x[n - d_i]: a sparse FIR over the static tap set."""
    out = torch.zeros_like(samples)
    for i, d in enumerate(ch.taps):
        out = out + coeffs[..., i, None] * apply_delay(samples, int(d))
    return out


def fade_awgn(generator: torch.Generator, samples: torch.Tensor, profile: str,
              srate: float, snr_db: float) -> tuple[torch.Tensor, torch.Tensor]:
    """TDL fade + AWGN; returns (rx, tap coefficients)."""
    ch = make_tdl(profile, srate)
    h = tdl_coefficients(generator, ch, samples.device)
    return awgn(generator, apply_tdl(samples, ch, h), snr_db), h


# ------------------------------------------------- HST / RLF trajectories

def hst_doppler_hz(t_s, fd_hz: float, period_s: float,
                   ds_m: float = 300.0, dmin_m: float = 2.0) -> torch.Tensor:
    """Instantaneous Doppler of the TS 36.141 high-speed-train scenario
    (srs-4G-UE/lib/src/phy/channel/hst.c:70-81): the train passes the base
    station once per ``period_s``, and the Doppler sweeps from +fd to -fd
    through the pass.  Vectorised over ``t_s``; float32."""
    t = torch.remainder(torch.as_tensor(t_s, dtype=torch.float32),
                        float(np.float32(period_s)))
    num = torch.where(t <= period_s / 2.0,
                      float(np.float32(period_s / 4.0)) - t,
                      t - float(np.float32(0.75 * period_s)))
    den = torch.sqrt(float(np.float32((dmin_m * period_s / (ds_m * 2.0)) ** 2))
                     + num * num)
    return float(np.float32(fd_hz)) * num / den


def apply_hst(samples: torch.Tensor, fd_hz: float, period_s: float,
              srate: float, slot_s: float = 1e-3,
              init_time_s: float = 0.0) -> torch.Tensor:
    """Apply the HST Doppler trajectory to an (S, total) slot batch, the
    Doppler held within each slot (hst.c:84) and applied as the phase ramp
    exp(-j 2 pi fs t)."""
    s, total = samples.shape
    dev = samples.device
    t_slots = init_time_s + np.arange(s, dtype=np.float32) * slot_s
    fs = hst_doppler_hz(torch.as_tensor(t_slots, device=dev), fd_hz, period_s)
    n = torch.arange(total, dtype=torch.float32, device=dev) / float(np.float32(srate))
    ph = float(np.float32(-2.0 * np.pi)) * fs[:, None] * n[None, :]
    return samples * torch.complex(torch.cos(ph), torch.sin(ph))


def apply_rlf(samples: torch.Tensor, t_on_ms: int, t_off_ms: int,
              slot_ms: float = 1.0, init_time_ms: float = 0.0) -> torch.Tensor:
    """Radio-link-failure emulation (srs-4G-UE/lib/src/phy/channel/rlf.c):
    unity gain for t_on_ms, zero for t_off_ms, slot-granular over an
    (S, total) batch."""
    s = samples.shape[0]
    period = float(t_on_ms + t_off_ms)
    t = np.mod(init_time_ms + np.arange(s, dtype=np.float64) * slot_ms, period)
    gain = torch.as_tensor((t < t_on_ms).astype(np.float32), device=samples.device)
    return samples * gain[:, None]
