"""PDCCH transmit tables: DCI polar code, scrambling, CCE-to-REG mapping and
DM-RS (TS 38.211 §7.3.2, §7.4.1.3; TS 38.212 §7.3).

Port of ``srsran_edgeric_5g_tpu/models/pdcch.py``: the DCI encoder (CRC24C
over 24 ones and the payload, RNTI-masked, polar K -> E), the CORESET
mapping (``process`` for one DCI, ``process_multi`` for several of one
search-space shape through one batched polar encode) and the UE-style
``blind_decode`` (demap -> descramble -> SC polar decode -> CRC against the
RNTI mask).  The full cell batches the same tables over slots
(``parallel.full_cell.pdcch_rows``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import modulation, sequences
from ..ops.crc import crc
from ..ops.polar import code as pcode, decoder as pdec, encoder as penc
from ..ops.polar import rate_match as prm
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


def _rnti_bits(rntis: list[int], device: torch.device) -> torch.Tensor:
    """(N, 16) MSB-first bits of each RNTI (the CRC mask)."""
    return torch.as_tensor([[(r >> (15 - i)) & 1 for i in range(16)]
                            for r in rntis], dtype=torch.int8, device=device)


def _masked_crc(payload: torch.Tensor, rntis: list[int]) -> torch.Tensor:
    """CRC24C over (24 ones ++ payload) with its last 16 bits XOR-masked by
    the RNTI: (N, A) -> (N, 24)."""
    pay = payload.to(torch.int8)
    ones = torch.ones((pay.shape[0], 24), dtype=torch.int8, device=pay.device)
    crc_bits = crc(torch.cat([ones, pay], dim=1), "crc24c")
    return torch.cat([crc_bits[:, :8],
                      crc_bits[:, 8:] ^ _rnti_bits(rntis, pay.device)], dim=1)


def encode_dci(payload: torch.Tensor, cfg: PdcchConfig) -> torch.Tensor:
    """(1, A) DCI bits -> (1, E) coded bits (TS 38.212 §7.3)."""
    k_bits = torch.cat([payload.to(torch.int8), _masked_crc(payload, [cfg.rnti])],
                       dim=1)
    return prm.rate_match(penc.encode(k_bits, _polar(cfg)), _polar(cfg))


def _scrambling_inits(cfgs: list[PdcchConfig], device: torch.device) -> torch.Tensor:
    return torch.as_tensor([_scrambling_cinit(c) for c in cfgs],
                           dtype=torch.int64, device=device)


def process(payload: torch.Tensor, cfg: PdcchConfig, nsymb: int,
            nsubc: int) -> torch.Tensor:
    """DCI payload -> (nsymb, nsubc) grid contribution (QPSK data + DM-RS)."""
    dev = payload.device
    scr = sequences.scramble_bits(encode_dci(payload, cfg),
                                  _scrambling_inits([cfg], dev))
    syms = modulation.modulate(scr, "qpsk")[0]
    data_sc, dmrs_sc = _re_positions(cfg)
    grid = torch.zeros((nsymb, nsubc), dtype=torch.complex64, device=dev)
    per_sym = syms.reshape(cfg.duration, -1)
    for off in range(cfg.duration):
        l = cfg.start_symbol + off
        grid[l, torch.as_tensor(data_sc, device=dev)] = per_sym[off]
        grid[l, torch.as_tensor(dmrs_sc, device=dev)] = torch.as_tensor(
            _dmrs_values(cfg, dmrs_sc, l), device=dev)
    return grid


def process_multi(payloads: torch.Tensor, cfgs: list[PdcchConfig], nsymb: int,
                  nsubc: int) -> torch.Tensor:
    """(N, A) DCI payloads -> one (nsymb, nsubc) CORESET grid.

    All cfgs share one search-space shape (payload size, aggregation level,
    start symbol, duration) so the whole set encodes through one batched
    polar chain; RNTIs, CCE indices and scrambling differ per DCI.  The
    reference's per-slot loop over PDCCH PDUs, batched."""
    cfg0 = cfgs[0]
    if payloads.shape[0] != len(cfgs):
        raise ValueError(f"{payloads.shape[0]} payloads for {len(cfgs)} DCIs")
    if not all(c.payload_bits == cfg0.payload_bits and c.e == cfg0.e
               and c.start_symbol == cfg0.start_symbol
               and c.duration == cfg0.duration for c in cfgs):
        raise ValueError("process_multi batches one search-space shape; "
                         "mixed sizes -> compose")
    if not all(c.n_id == cfg0.n_id and c.slot == cfg0.slot for c in cfgs):
        raise ValueError("one CORESET: pdcch-DMRS-ScramblingID and slot must "
                         "match")
    dev = payloads.device
    n = len(cfgs)
    pay = payloads.to(torch.int8)
    code = _polar(cfg0)
    cw = penc.encode(torch.cat([pay, _masked_crc(pay, [c.rnti for c in cfgs])],
                               dim=1), code)
    scr = sequences.scramble_bits(prm.rate_match(cw, code),
                                  _scrambling_inits(cfgs, dev))
    syms = modulation.modulate(scr, "qpsk")                 # (N, E/2)

    pos = [_re_positions(c) for c in cfgs]
    data_sc = np.concatenate([p[0] for p in pos])
    if len(np.unique(data_sc)) != len(data_sc):
        raise ValueError("overlapping CCEs")
    dmrs_sc = np.unique(np.concatenate([p[1] for p in pos]))
    per_sym = syms.reshape(n, cfg0.duration, -1)           # (N, dur, d/sym)
    grid = torch.zeros((nsymb, nsubc), dtype=torch.complex64, device=dev)
    for off in range(cfg0.duration):
        l = cfg0.start_symbol + off
        grid[l, torch.as_tensor(data_sc, device=dev)] = per_sym[:, off].reshape(-1)
        grid[l, torch.as_tensor(dmrs_sc, device=dev)] = torch.as_tensor(
            _dmrs_values(cfg0, dmrs_sc, l), device=dev)
    return grid


def blind_decode(rx_grid: torch.Tensor, cfg: PdcchConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """UE-style receive for loopback tests: ((1, A) payload, (1,) ok).

    Assumes the channel is already equalised (or clean); the DM-RS enter
    only through CRC success."""
    dev = rx_grid.device
    data_sc, _ = _re_positions(cfg)
    syms = torch.cat([rx_grid[cfg.start_symbol + off,
                              torch.as_tensor(data_sc, device=dev)]
                      for off in range(cfg.duration)])
    llr = modulation.demodulate_soft(syms[None], torch.tensor(0.1, device=dev),
                                     "qpsk", quantize=False)
    llr = sequences.scramble_llrs(llr, _scrambling_inits([cfg], dev))
    c = _polar(cfg)
    decoded = pdec.decode(prm.rate_dematch(llr, c), c)    # (1, K)
    payload, crc_rx = decoded[:, :cfg.payload_bits], decoded[:, cfg.payload_bits:]
    ok = torch.all(_masked_crc(payload, [cfg.rnti]) == crc_rx, dim=1)
    return payload, ok
