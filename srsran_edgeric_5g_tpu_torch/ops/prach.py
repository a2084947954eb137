"""PRACH preamble generation and detection (TS 38.211 §6.3.3).

Port of ``srsran_edgeric_5g_tpu/ops/prach.py`` (the reference's
prach_generator_impl.cpp and prach_detector_generic_impl.cpp): root
sequences and the logical-to-physical root table (this package's
``data/ldpc_graphs.npz``), the N_cs tables, the cell's 64-preamble space
(``PrachConfig``, unrestricted and restricted set A), the frequency-domain
preamble, every TS 38.211 format's occasion layout, the occasion modulator
and demodulator, and the detector.  The reference routes the occasion-sized
DFT (fs / 1.25 kHz = 18432 points at 23.04 Msps) through a TPU matmul-DFT;
here it is one ``torch.fft.fft``.

The detector correlates the occasion against every root of the cell at once
(conj-multiply + IDFT batched over roots) and takes each preamble's peak
over its own N_cs zone by one gather of the 64 zones, where the reference
slices the 64 zones in a Python loop.
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib

import numpy as np
import torch

from ..device import resolve_device

_DATA = pathlib.Path(__file__).resolve().parents[1] / "data" / "ldpc_graphs.npz"

L_LONG = 839
L_SHORT = 139


@functools.lru_cache(maxsize=None)
def _root_tables():
    d = np.load(_DATA)
    return {L_LONG: d["prach_root_long"], L_SHORT: d["prach_root_short"]}


def sequence_number(logical_index: int, l_ra: int = L_LONG) -> int:
    """Logical root sequence index -> physical u (Tables 6.3.3.1-3/-4)."""
    return int(_root_tables()[l_ra][logical_index % (l_ra - 1)])


@functools.lru_cache(maxsize=None)
def root_sequence(u: int, l_ra: int = L_LONG) -> np.ndarray:
    """x_u(n) = exp(-j pi u n (n+1) / L), complex64."""
    n = np.arange(l_ra, dtype=np.float64)
    return np.exp(-1j * np.pi * u * n * (n + 1) / l_ra).astype(np.complex64)


# TS 38.211 Table 6.3.3.1-5 (1.25 kHz preamble SCS): zeroCorrelationZone
# config -> N_cs per restricted-set column (None = reserved).
NCS_125K = {
    None: (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119, 167, 279, 419),
    "a": (15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 128, 158, 202, 237, None),
    "b": (15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 118, 137, None, None, None),
}

# TS 38.211 Table 6.3.3.1-6 (5 kHz preamble SCS, long format 3).
NCS_5K = {
    None: (0, 13, 26, 33, 38, 41, 49, 55, 64, 76, 93, 119, 139, 209, 279, 419),
    "a": (36, 57, 72, 81, 89, 94, 103, 112, 121, 132, 137, 152, 173, 195, 216,
          237),
    "b": (36, 57, 60, 63, 65, 68, 71, 77, 81, 85, 97, 109, 122, 137, None,
          None),
}


# TS 38.211 Table 6.3.3.1-7: short preambles (15 kHz x 2^mu SCS),
# unrestricted sets only.
NCS_SHORT = (0, 2, 4, 6, 8, 10, 12, 13, 15, 17, 19, 23, 27, 34, 46, 69)


def ncs_from_zcz(zcz_config: int, restricted: str | None = None,
                 scs_hz: int = 1250) -> int:
    """zeroCorrelationZoneConfig -> N_cs for long preambles (1.25 / 5 kHz)."""
    v = (NCS_125K if scs_hz == 1250 else NCS_5K)[restricted][zcz_config]
    if v is None:
        raise ValueError(f"zcz {zcz_config} reserved for set {restricted}")
    return v


def ncs_from_zcz_short(zcz_config: int) -> int:
    """zeroCorrelationZoneConfig -> N_cs for short (L=139) preambles."""
    return NCS_SHORT[zcz_config]


def _cyclic_shift_distance(u: int, l_ra: int) -> int:
    """d_u (TS 38.211 §6.3.3.1): p = u^-1 mod L folded into [0, L/2]."""
    p = pow(u, -1, l_ra)
    return p if p < l_ra / 2 else l_ra - p


def restricted_cyclic_shifts(u: int, n_cs: int, l_ra: int = L_LONG
                             ) -> list[int]:
    """Allowed C_v values for root u under restricted set type A."""
    d_u = _cyclic_shift_distance(u, l_ra)
    if n_cs <= d_u < l_ra / 3:
        n_shift = d_u // n_cs
        d_start = 2 * d_u + n_shift * n_cs
        n_group = l_ra // d_start
        n_bar = max((l_ra - 2 * d_u - n_group * d_start) // n_cs, 0)
    elif l_ra / 3 <= d_u <= (l_ra - n_cs) / 2:
        n_shift = (l_ra - 2 * d_u) // n_cs
        d_start = l_ra - 2 * d_u + n_shift * n_cs
        n_group = d_u // d_start
        n_bar = min(max((d_u - n_group * d_start) // n_cs, 0), n_shift)
    else:
        return []
    if n_shift == 0:
        return []
    w = n_shift * n_group + n_bar
    return [d_start * (v // n_shift) + (v % n_shift) * n_cs for v in range(w)]


@dataclasses.dataclass(frozen=True)
class PrachConfig:
    """One cell's preamble space: 64 preambles from consecutive logical roots.

    Unrestricted: N_cs-spaced shifts, L / N_cs per root.  Restricted set A:
    the Doppler-robust shift groups of §6.3.3.1 (a variable count per root,
    walking logical roots until 64 preambles exist)."""

    root_sequence_index: int
    zero_correlation_zone: int   # N_cs directly (0 => one shift per root)
    l_ra: int = L_LONG
    restricted: str | None = None  # None | 'a'

    @property
    def n_cs(self) -> int:
        return self.zero_correlation_zone

    @property
    def shifts_per_root(self) -> int:
        return 1 if self.n_cs == 0 else self.l_ra // self.n_cs

    @functools.cached_property
    def preamble_table(self) -> tuple[tuple[int, int, int], ...]:
        """64 x (root_offset, u, C_v)."""
        out = []
        offset = 0
        while len(out) < 64:
            u = sequence_number(self.root_sequence_index + offset, self.l_ra)
            if self.restricted is None:
                shifts = ([0] if self.n_cs == 0 else
                          [v * self.n_cs for v in range(self.shifts_per_root)])
            elif self.restricted == "a":
                shifts = restricted_cyclic_shifts(u, self.n_cs, self.l_ra)
            else:
                raise ValueError(self.restricted)
            for cv in shifts:
                if len(out) < 64:
                    out.append((offset, u, cv))
            offset += 1
            if offset >= 838:
                raise ValueError("cannot build 64 preambles")
        return tuple(out)

    def preamble(self, index: int) -> tuple[int, int]:
        """Preamble index (0..63) -> (u, cyclic shift C_v)."""
        _, u, cv = self.preamble_table[index]
        return u, cv


def generate(cfg: PrachConfig, preamble_index: int,
             device: str | torch.device = "cuda") -> torch.Tensor:
    """Frequency-domain preamble y_{u,v} = DFT(x_u cyclically shifted by
    C_v): (L_RA,) complex64, the sequence mapped to the PRACH subcarriers."""
    u, cv = cfg.preamble(preamble_index)
    x = np.roll(root_sequence(u, cfg.l_ra), -cv)
    return torch.as_tensor(np.fft.fft(x).astype(np.complex64),
                           device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class PrachOfdmInfo:
    """Time-domain layout of one PRACH occasion at a given sample rate."""

    l_ra: int
    dft_size: int          # fs / preamble_scs
    cp_samples: int
    freq_offset_bins: int  # first preamble bin within the PRACH DFT
    n_reps: int = 1        # preamble symbol repetitions after the single CP


# TS 38.211 Tables 6.3.3.1-1/-2 (the reference's
# prach_preamble_information.cpp:30-118): format -> (L_RA, preamble SCS at
# mu = 0, symbol repetitions, CP length in kappa units = samples at 30.72
# Msps; short-format CP values are the mu = 0 column and scale as >> mu).
PRACH_FORMATS = {
    "0": (839, 1250, 1, 3168),
    "1": (839, 1250, 2, 21024),
    "2": (839, 1250, 4, 4688),
    "3": (839, 5000, 4, 3168),
    "A1": (139, 15000, 2, 288),
    "A2": (139, 15000, 4, 576),
    "A3": (139, 15000, 6, 864),
    "B1": (139, 15000, 2, 216),
    "B4": (139, 15000, 12, 936),
    "C0": (139, 15000, 1, 1240),
    "C2": (139, 15000, 4, 2048),
}


def prach_format_info(fmt: str, srate: int, mu: int = 0,
                      freq_offset_hz: float = 0.0) -> PrachOfdmInfo:
    """Time-domain occasion layout of any TS 38.211 preamble format."""
    l_ra, scs, n_reps, cp_kappa = PRACH_FORMATS[fmt]
    if l_ra == L_SHORT:
        scs <<= mu
        cp_kappa >>= mu
    if srate % scs:
        raise ValueError(f"sample rate {srate} is not a multiple of {scs}")
    return PrachOfdmInfo(l_ra=l_ra, dft_size=srate // scs,
                         cp_samples=int(round(cp_kappa * srate / 30.72e6)),
                         freq_offset_bins=int(round(freq_offset_hz / scs)),
                         n_reps=n_reps)


def prach_ofdm_info(srate: int, l_ra: int = L_LONG, cp_us: float = 103.0,
                    freq_offset_hz: float = 0.0) -> PrachOfdmInfo:
    """Format-0-style layout: preamble SCS 1.25 kHz (long) / 15 kHz (short)."""
    scs = 1250 if l_ra == L_LONG else 15000
    if srate % scs:
        raise ValueError(f"sample rate {srate} is not a multiple of {scs}")
    return PrachOfdmInfo(l_ra=l_ra, dft_size=srate // scs,
                         cp_samples=int(round(srate * cp_us * 1e-6)),
                         freq_offset_bins=int(round(freq_offset_hz / scs)))


@functools.lru_cache(maxsize=None)
def _bins(info: PrachOfdmInfo, device: torch.device) -> torch.Tensor:
    k = (info.freq_offset_bins + np.arange(info.l_ra)) % info.dft_size
    return torch.as_tensor(k, device=device)


def ofdm_demodulate_prach(samples: torch.Tensor,
                          info: PrachOfdmInfo) -> torch.Tensor:
    """(..., cp + n_reps*dft) samples -> frequency-domain preamble: (..., L_RA)
    for one repetition, (..., n_reps, L_RA) otherwise.  CP strip, one DFT per
    repetition, bin extraction, 1/sqrt(dft) (unitary with the modulator)."""
    body = samples[..., info.cp_samples:
                   info.cp_samples + info.n_reps * info.dft_size]
    if info.n_reps > 1:
        body = body.reshape(*body.shape[:-1], info.n_reps, info.dft_size)
    fd = torch.fft.fft(body, dim=-1).to(torch.complex64)
    return fd[..., _bins(info, samples.device)] * float(
        np.float32(1.0 / np.sqrt(info.dft_size)))


def ofdm_modulate_prach(preamble_freq: torch.Tensor,
                        info: PrachOfdmInfo) -> torch.Tensor:
    """(..., L_RA) frequency preamble -> (..., cp + n_reps*dft) samples: one
    CP (the cyclic tail of the symbol) then n_reps contiguous repetitions of
    the symbol (phase-continuous, TS 38.211 Tables 6.3.3.1-1/-2)."""
    dev = preamble_freq.device
    x = torch.zeros((*preamble_freq.shape[:-1], info.dft_size),
                    dtype=torch.complex64, device=dev)
    x[..., _bins(info, dev)] = preamble_freq.to(torch.complex64)
    td = torch.fft.ifft(x, dim=-1).to(torch.complex64) * float(
        np.float32(np.sqrt(info.dft_size)))
    cp = td[..., info.dft_size - info.cp_samples:]
    return torch.cat([cp] + [td] * info.n_reps, dim=-1)


@dataclasses.dataclass
class PrachDetection:
    metrics: torch.Tensor      # (64,) peak-to-noise metric per preamble
    delays: torch.Tensor       # (64,) peak delay (samples in the L_RA domain)
    detected: torch.Tensor     # (64,) bool, metric above threshold


@functools.lru_cache(maxsize=None)
def _detect_tables(cfg: PrachConfig, device: torch.device):
    """conj(DFT) of the cell's roots (R, L), each preamble's root row (64, 1)
    and its N_cs zone (64, win) into the doubled delay axis."""
    l_ra = cfg.l_ra
    table = cfg.preamble_table
    offsets = sorted({off for off, _, _ in table})
    row_of = {off: i for i, off in enumerate(offsets)}
    roots = np.stack([root_sequence(sequence_number(
        cfg.root_sequence_index + off, l_ra), l_ra) for off in offsets])
    root_f = np.fft.fft(roots, axis=-1).astype(np.complex64)
    win = min(cfg.n_cs if cfg.n_cs else l_ra, l_ra)
    rows = np.asarray([row_of[off] for off, _, _ in table])[:, None]
    # x_{u,v}(n) = x_u((n + C_v) mod L) puts the zero-delay peak at
    # (L - C_v) mod L; each preamble's zone starts there and spans N_cs.
    starts = np.asarray([(l_ra - cv) % l_ra for _, _, cv in table])
    zone = starts[:, None] + np.arange(win)[None, :]
    return (torch.as_tensor(root_f.conj(), device=device),
            torch.as_tensor(rows, device=device),
            torch.as_tensor(zone, device=device))


def detect_batch(rx_freq: torch.Tensor, cfg: PrachConfig, threshold: float = 20.0
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, L_RA) frequency-domain occasions -> ((B, 64) metrics, delays,
    detected): per-root correlation by IDFT, each preamble's peak over its
    own N_cs zone against the occasion's mean correlation power."""
    root_conj, rows, zone = _detect_tables(cfg, rx_freq.device)
    corr_t = torch.fft.ifft(rx_freq[:, None, :] * root_conj, dim=-1)
    power = corr_t.abs() ** 2                               # (B, R, L)
    floor = power.mean(dim=(1, 2))[:, None] + 1e-30
    power2 = torch.cat([power, power], dim=-1)              # wrap-around
    zones = power2[:, rows, zone]                           # (B, 64, win)
    delays = torch.argmax(zones, dim=-1)
    metrics = torch.gather(zones, 2, delays[..., None])[..., 0] / floor
    return metrics, delays, metrics > threshold


def detect(rx_freq: torch.Tensor, cfg: PrachConfig,
           threshold: float = 20.0) -> PrachDetection:
    """Detect preambles from the (L_RA,) frequency-domain PRACH window.

    corr_u(t) = IDFT(rx * conj(DFT(x_u))): a preamble sent with shift C_v
    peaks at t = C_v + propagation delay, so each preamble's metric is the
    max over its own N_cs zone, normalised by the mean correlation power
    (the noise floor).  An (n_reps, L_RA) input (repeated formats) is first
    averaged coherently over the repetitions (the reference's
    combine_symbols, prach_detector_generic_impl.cpp:240-251)."""
    if rx_freq.ndim == 2:
        rx_freq = torch.mean(rx_freq, dim=0)
    metrics, delays, detected = detect_batch(rx_freq[None], cfg, threshold)
    return PrachDetection(metrics=metrics[0], delays=delays[0],
                          detected=detected[0])
