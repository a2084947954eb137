"""PDCCH transmit tables: DCI polar code, scrambling, CCE-to-REG mapping and
DM-RS (TS 38.211 §7.3.2, §7.4.1.3; TS 38.212 §7.3).

Port of the host-side parts of ``srsran_edgeric_5g_tpu/models/pdcch.py`` that
the full cell's batched PDCCH uses (``parallel.full_cell.pdcch_rows``).  The
receive side (blind decode) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops import sequences
from ..ops.polar import code as pcode
from ..ran.numerology import N_SC_PER_PRB

RE_PER_CCE_DATA = 54   # 6 REGs x 12 RE minus 18 DM-RS
DMRS_PER_CCE = 18


@dataclasses.dataclass(frozen=True)
class PdcchConfig:
    rnti: int
    n_id: int                 # pdcch-DMRS-ScramblingID (and data scrambling)
    aggregation_level: int    # 1/2/4/8/16 CCEs
    cce_index: int            # first CCE in the CORESET
    start_symbol: int = 0
    coreset_start_prb: int = 0
    slot: int = 0
    payload_bits: int = 40    # DCI size A
    coreset_nof_prb: int = 48
    duration: int = 1         # CORESET symbols {1, 2, 3}
    interleaved: bool = False
    interleaver_rows: int = 2
    shift_index: int = 0
    reg_bundle_size: int = 6  # L (interleaved only)

    @property
    def e(self) -> int:
        return 2 * RE_PER_CCE_DATA * self.aggregation_level  # QPSK bits

    @property
    def k(self) -> int:
        return self.payload_bits + 24


def _polar(cfg: PdcchConfig) -> pcode.PolarCode:
    return pcode.construct(cfg.k, cfg.e, nmax=pcode.NMAX_DL, i_il=True)


def _scrambling_cinit(cfg: PdcchConfig) -> int:
    """TS 38.211 §7.3.2.3: c_init = (n_rnti*2^16 + n_id) mod 2^31."""
    return ((cfg.rnti << 16) + cfg.n_id) % (1 << 31)


def cce_to_bundle(cfg: PdcchConfig, x: int) -> int:
    """Source REG-bundle index x -> destination bundle (§7.3.2.2):
    identity when not interleaved, else f(x) = (r*C + c + n_shift) mod
    n_bundles with x = c*R + r."""
    if not cfg.interleaved:
        return x
    n_bundles = cfg.coreset_nof_prb * cfg.duration // cfg.reg_bundle_size
    r_rows = cfg.interleaver_rows
    if n_bundles % r_rows:
        raise ValueError(f"{n_bundles} REG bundles over {r_rows} rows")
    c, r = divmod(x, r_rows)
    return (r * (n_bundles // r_rows) + c + cfg.shift_index) % n_bundles


def _alloc_prbs(cfg: PdcchConfig) -> np.ndarray:
    """Sorted PRB indices of the PDCCH allocation (time-first REG numbering:
    each destination bundle covers L/duration whole PRBs)."""
    lb = cfg.reg_bundle_size if cfg.interleaved else 6
    if cfg.duration not in (1, 2, 3) or lb % cfg.duration:
        raise ValueError(f"bundle size {lb}, duration {cfg.duration}")
    bundles_per_cce = max(6 // lb, 1)
    prbs_per_bundle = lb // cfg.duration
    prbs: set[int] = set()
    for c in range(cfg.aggregation_level):
        for i in range(bundles_per_cce):
            dst = cce_to_bundle(cfg, (cfg.cce_index + c) * bundles_per_cce + i)
            first = cfg.coreset_start_prb + prbs_per_bundle * dst
            prbs.update(range(first, first + prbs_per_bundle))
    return np.asarray(sorted(prbs), np.int64)


def _re_positions(cfg: PdcchConfig) -> tuple[np.ndarray, np.ndarray]:
    """(data_sc, dmrs_sc) absolute subcarriers of one CORESET symbol; DM-RS
    on subcarriers 4k+1."""
    sc = np.concatenate([np.arange(p * N_SC_PER_PRB, (p + 1) * N_SC_PER_PRB)
                         for p in _alloc_prbs(cfg)])
    return sc[sc % 4 != 1], sc[sc % 4 == 1]


def _dmrs_values(cfg: PdcchConfig, dmrs_sc: np.ndarray,
                 symbol: int) -> np.ndarray:
    """PDCCH DM-RS (§7.4.1.3) at absolute pilot subcarriers of one CORESET
    symbol; the sequence index of a pilot is floor(sc / 4)."""
    cinit = ((1 << 17) * (14 * cfg.slot + symbol + 1) * (2 * cfg.n_id + 1)
             + 2 * cfg.n_id) % (1 << 31)
    idx = np.asarray(dmrs_sc) // 4
    c = sequences.np_gold_sequence(cinit, 2 * (int(idx.max()) + 1))
    pil = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)
    return pil[idx].astype(np.complex64)
