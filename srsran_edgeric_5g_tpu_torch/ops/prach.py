"""PRACH preamble tables and occasion demodulation (TS 38.211 §6.3.3).

Port of the parts of ``srsran_edgeric_5g_tpu/ops/prach.py`` the full cell
uses: root sequences and the logical-to-physical root table (this package's
``data/ldpc_graphs.npz``), the N_cs tables, the cell's 64-preamble space
(``PrachConfig``), the occasion layout and the occasion demodulator.  The
reference routes the occasion-sized DFT (fs / 1.25 kHz = 18432 points at
23.04 Msps) through a TPU matmul-DFT; here it is one ``torch.fft.fft``.
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib

import numpy as np
import torch

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


def ncs_from_zcz(zcz_config: int, restricted: str | None = None,
                 scs_hz: int = 1250) -> int:
    """zeroCorrelationZoneConfig -> N_cs for long preambles (1.25 / 5 kHz)."""
    v = (NCS_125K if scs_hz == 1250 else NCS_5K)[restricted][zcz_config]
    if v is None:
        raise ValueError(f"zcz {zcz_config} reserved for set {restricted}")
    return v


@dataclasses.dataclass(frozen=True)
class PrachConfig:
    """One cell's preamble space: 64 preambles from consecutive logical roots,
    unrestricted set (N_cs-spaced cyclic shifts, L / N_cs per root)."""

    root_sequence_index: int
    zero_correlation_zone: int   # N_cs directly (0 => one shift per root)
    l_ra: int = L_LONG
    restricted: str | None = None

    @property
    def n_cs(self) -> int:
        return self.zero_correlation_zone

    @property
    def shifts_per_root(self) -> int:
        return 1 if self.n_cs == 0 else self.l_ra // self.n_cs

    @functools.cached_property
    def preamble_table(self) -> tuple[tuple[int, int, int], ...]:
        """64 x (root_offset, u, C_v)."""
        if self.restricted is not None:
            raise NotImplementedError("restricted PRACH sets are not ported yet")
        out = []
        offset = 0
        while len(out) < 64:
            u = sequence_number(self.root_sequence_index + offset, self.l_ra)
            shifts = ([0] if self.n_cs == 0 else
                      [v * self.n_cs for v in range(self.shifts_per_root)])
            for cv in shifts:
                if len(out) < 64:
                    out.append((offset, u, cv))
            offset += 1
        return tuple(out)

    def preamble(self, index: int) -> tuple[int, int]:
        """Preamble index (0..63) -> (u, cyclic shift C_v)."""
        _, u, cv = self.preamble_table[index]
        return u, cv


@dataclasses.dataclass(frozen=True)
class PrachOfdmInfo:
    """Time-domain layout of one PRACH occasion at a given sample rate."""

    l_ra: int
    dft_size: int          # fs / preamble_scs
    cp_samples: int
    freq_offset_bins: int  # first preamble bin within the PRACH DFT
    n_reps: int = 1        # preamble symbol repetitions after the single CP


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
