"""DM-RS generation for PDSCH/PUSCH (TS 38.211 §6.4.1.1 / §7.4.1.1).

Port of ``srsran_edgeric_5g_tpu/ops/dmrs.py``: Gold-sequence QPSK pilots
with configuration-type-1/2 subcarrier mapping, batched over c_init rows,
and their mapping into (and extraction from) a resource grid.  Single-symbol
DM-RS without time OCC, ports 0-3 with frequency OCC.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .sequences import gold_sequence

SQRT1_2 = float(np.float32(1.0 / np.sqrt(2.0)))


def dmrs_c_init(slot: int, symbol: int, n_id: int, n_scid: int = 0) -> int:
    """TS 38.211 §7.4.1.1.1 (same formula §6.4.1.1.1 for PUSCH)."""
    nsymb = 14
    return ((2 ** 17 * (nsymb * slot + symbol + 1) * (2 * n_id + 1)
             + 2 * n_id + n_scid) % (2 ** 31))


@dataclasses.dataclass(frozen=True, eq=False)
class DmrsPattern:
    """Static DM-RS layout for one (config_type, port) combination."""

    config_type: int          # 1 or 2
    nof_prb: int
    delta: int                # CDM group frequency offset
    subcarriers: np.ndarray   # (npilots,) subcarrier indices
    wf: np.ndarray            # (npilots,) frequency OCC for the port


@functools.lru_cache(maxsize=None)
def dmrs_pattern(config_type: int, nof_prb: int, port: int = 0) -> DmrsPattern:
    """Pilot subcarrier positions and frequency OCC for one antenna port.

    Type 1: pilots on subcarriers 4n + 2k' + delta, 6 per PRB, CDM group
    delta = (port // 2) % 2; w_f = (-1)^k' for odd ports.
    Type 2: pilots on 6n + k' + delta (k' in {0,1}), 4 per PRB.
    """
    kprime = np.arange(2)
    if config_type == 1:
        delta = (port // 2) % 2
        sc = (4 * np.repeat(np.arange(3 * nof_prb), 2)
              + 2 * np.tile(kprime, 3 * nof_prb) + delta)
        reps = 3 * nof_prb
    elif config_type == 2:
        delta = 2 * ((port // 2) % 3)
        sc = (6 * np.repeat(np.arange(2 * nof_prb), 2)
              + np.tile(kprime, 2 * nof_prb) + delta)
        reps = 2 * nof_prb
    else:
        raise ValueError(f"bad config type {config_type}")
    wf = (np.where(np.tile(kprime, reps) == 1, -1.0, 1.0) if port % 2 == 1
          else np.ones(2 * reps))
    return DmrsPattern(config_type=config_type, nof_prb=nof_prb, delta=delta,
                       subcarriers=sc.astype(np.int64), wf=wf.astype(np.float32))


def dmrs_sequence(c_init: torch.Tensor, npilots: int,
                  skip_pilots: int = 0) -> torch.Tensor:
    """QPSK pilots r(m) = ((1-2c(2m)) + j(1-2c(2m+1)))/sqrt(2), batched over
    c_init rows -> (B, npilots) complex64.  ``skip_pilots`` drops the first
    sequence elements (allocations not starting at PRB 0)."""
    nbits = 2 * (npilots + skip_pilots)
    c = gold_sequence(c_init, nbits).to(torch.float32)[..., 2 * skip_pilots:]
    re = (1.0 - 2.0 * c[..., 0::2]) * SQRT1_2
    im = (1.0 - 2.0 * c[..., 1::2]) * SQRT1_2
    return torch.complex(re, im)


def map_dmrs(grid: torch.Tensor, pilots: torch.Tensor, pattern: DmrsPattern,
             symbol: int, amplitude: float = 1.0) -> torch.Tensor:
    """Write pilots into a (..., nsymb, nsubc) grid at the DM-RS symbol; the
    grid is not modified, a new one is returned."""
    wf = torch.as_tensor(pattern.wf, device=grid.device)
    vals = pilots * wf * float(np.float32(amplitude))
    out = grid.clone()
    out[..., symbol, torch.as_tensor(pattern.subcarriers, device=grid.device)] = \
        vals.to(grid.dtype)
    return out


def extract_dmrs(grid: torch.Tensor, pattern: DmrsPattern,
                 symbol: int) -> torch.Tensor:
    """Read pilot REs from a (..., nsymb, nsubc) grid -> (..., npilots)."""
    return grid[..., symbol,
                torch.as_tensor(pattern.subcarriers, device=grid.device)]
