"""PDSCH transmit processor: TB bits -> resource-grid contribution.

Port of ``srsran_edgeric_5g_tpu/models/pdsch.py`` (the reference's
pdsch_processor_impl.cpp: segment + CRC -> LDPC encode -> rate match ->
scramble -> modulate -> RE map -> DM-RS), for one UE at a time.  Codeblocks
are the batch dimension of the encoder.

Static configuration (allocation, MCS, DM-RS layout, LBRM, DFT-s-OFDM, the
DC position) lives in the hashable ``PdschConfig``; the plans and the
constant tensors (pilots, index vectors) are built once per configuration
and device and cached, so a slot only moves its payload.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import dmrs as dmrs_mod
from ..ops import low_papr, modulation, precoding, sequences
from ..ops.ldpc import encoder, rate_match, segmenter
from ..ran.numerology import N_SC_PER_PRB
from ..ran.tbs import nof_re, tbs as tbs_calc


@dataclasses.dataclass(frozen=True)
class PdschConfig:
    """Static per-UE PDSCH (and PUSCH) parameters for one slot."""

    rnti: int
    nof_prb: int                      # allocation width
    start_prb: int                    # within the grid
    first_symbol: int = 2             # data + DM-RS span start
    nof_symbols: int = 12             # span length
    dmrs_symbols: tuple[int, ...] = (2, 11)   # absolute symbol indices
    modulation: str = "qam64"
    target_rate: float = 0.5          # code rate for TBS derivation
    n_id: int = 1                     # scrambling / DM-RS identity
    n_scid: int = 0
    slot: int = 0
    tbs: int | None = None            # explicit TBS (bits); derived if None
    # Limited-buffer rate matching (TS 38.212 §5.4.2.1): 0 = full buffer
    # N_cb = N; > 0 shortens the circular buffer to N_ref from this TBS_LBRM.
    tbs_lbrm: int = 0
    # DFT-s-OFDM (PUSCH transform precoding, TS 38.211 §6.3.1.4): per-symbol
    # DFT spread on TX, iDFT despread after equalisation on RX; the DM-RS is
    # the low-PAPR sequence (u = n_id mod 30, no hopping, see pilot_values).
    transform_precoding: bool = False
    # Grid subcarrier index of the radio's DC (None: no DC inside the band).
    # The receiver zeroes the channel estimate there, so the equaliser's
    # abnormal-input rule erases that RE's LLRs.
    dc_position: int | None = None

    @property
    def data_symbols(self) -> tuple[int, ...]:
        return tuple(s for s in range(self.first_symbol,
                                      self.first_symbol + self.nof_symbols)
                     if s not in self.dmrs_symbols)

    @property
    def qm(self) -> int:
        return modulation.QM[self.modulation]

    @property
    def nof_data_re(self) -> int:
        return len(self.data_symbols) * self.nof_prb * N_SC_PER_PRB

    @property
    def g_total(self) -> int:
        """Total rate-matched bits G."""
        return self.nof_data_re * self.qm

    def derived_tbs(self) -> int:
        """TBS (payload bits): the explicit override, or TS 38.214 §5.1.3.2
        with 12 DM-RS REs per PRB per DM-RS symbol (no data there)."""
        if self.tbs is not None:
            return self.tbs
        nre = nof_re(self.nof_prb, self.nof_symbols,
                     12 * len(self.dmrs_symbols))
        return tbs_calc(nre, self.target_rate, self.qm)


@functools.lru_cache(maxsize=None)
def _plans(cfg: PdschConfig, rv: int = 0, e_total: int | None = None):
    """(segment plan, rate-match plans by ascending E).  ``e_total``
    overrides the rate-matched length (UCI on PUSCH rate-matches the UL-SCH
    around the UCI REs: E = G - G_uci)."""
    tbs = cfg.derived_tbs()
    bg = segmenter.select_base_graph(tbs, cfg.target_rate)
    seg = segmenter.get_segment_plan(tbs, bg, e_total or cfg.g_total, cfg.qm)
    n_cb = (rate_match.lbrm_n_cb(seg.bg, seg.zc, seg.c, cfg.tbs_lbrm)
            if cfg.tbs_lbrm > 0 else None)
    rms = tuple(rate_match.get_rate_match_plan(seg.bg, seg.zc, e, rv, cfg.qm,
                                               seg.k_prime, n_cb=n_cb)
                for e in sorted(set(seg.e)))
    return seg, rms


def cb_runs(seg, rms):
    """Consecutive codeblocks of equal E as (first, end, rate-match plan):
    one run for a uniform split, short then long for an unequal one
    (TS 38.212 §5.4.2.1 puts the short codeblocks first)."""
    runs, i0 = [], 0
    for i in range(1, seg.c + 1):
        if i == seg.c or seg.e[i] != seg.e[i0]:
            runs.append((i0, i, next(p for p in rms if p.e == seg.e[i0])))
            i0 = i
    return runs


def scrambling_c_init(rnti: int, n_id: int, q: int = 0) -> int:
    """TS 38.211 §7.3.1.1: c_init = rnti*2^15 + q*2^14 + n_id."""
    return (rnti << 15) + (q << 14) + n_id


@functools.lru_cache(maxsize=None)
def c_init_on(rnti: int, n_id: int, device: torch.device) -> torch.Tensor:
    """(1,) scrambling initialiser of one UE on ``device``."""
    return torch.tensor([scrambling_c_init(rnti, n_id)], dtype=torch.int64,
                        device=device)


def encode_transport_block(payload: torch.Tensor, cfg: PdschConfig,
                           rv: int = 0, scramble: bool = True,
                           e_total: int | None = None) -> torch.Tensor:
    """(1, TBS) payload bits -> (1, G) scrambled codeword bits.

    ``scramble=False`` returns the stream before scrambling (UCI on PUSCH
    multiplexes between rate matching and scrambling); ``e_total`` shortens
    the rate-matched length (the SCH around the UCI)."""
    seg, rms = _plans(cfg, rv, e_total)
    cbs = segmenter.segment_tb(payload, seg)          # (C, K)
    cw = encoder.encode(cbs, seg.bg, seg.zc)          # (C, cols*Zc)
    bits = torch.cat([rate_match.rate_match(cw[i0:i1], plan).reshape(-1)
                      for i0, i1, plan in cb_runs(seg, rms)])[None, :]
    if not scramble:
        return bits
    return sequences.scramble_bits(bits, c_init_on(cfg.rnti, cfg.n_id,
                                                   bits.device))


@functools.lru_cache(maxsize=None)
def _pilot_values(cfg: PdschConfig, l: int, npil: int,
                  device: torch.device) -> torch.Tensor:
    if cfg.transform_precoding:
        seq = low_papr.base_sequence(cfg.n_id % 30, 0, npil)
        return torch.as_tensor(seq.astype(np.complex64), device=device)
    ci = torch.tensor([dmrs_mod.dmrs_c_init(cfg.slot, l, cfg.n_id, cfg.n_scid)],
                      dtype=torch.int64, device=device)
    return dmrs_mod.dmrs_sequence(ci, npil, skip_pilots=6 * cfg.start_prb)[0]


def pilot_values(cfg: PdschConfig, l: int, pat,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """DM-RS values for symbol ``l`` over ``pat``'s pilots (without w_f), on
    ``device``.

    CP-OFDM: Gold pseudo-random QPSK (TS 38.211 §7.4.1.1.1).  Transform
    precoding (DFT-s-OFDM): the low-PAPR sequence r_{u,v} with
    u = n_id mod 30, v = 0, alpha = 0 (TS 38.211 §6.4.1.1.3)."""
    return _pilot_values(cfg, l, len(pat.subcarriers), torch.device(device))


@dataclasses.dataclass(frozen=True, eq=False)
class GridLayout:
    """One configuration's constant grid tensors on one device."""

    data_symbols: torch.Tensor   # (ndata,) symbol indices
    pilot_sc: torch.Tensor       # (npil,) grid subcarriers of the port-0 pilots
    wf: torch.Tensor             # (npil,) frequency OCC
    pilots: tuple                # per DM-RS symbol: pilot_values * w_f


@functools.lru_cache(maxsize=None)
def grid_layout(cfg: PdschConfig, device: torch.device) -> GridLayout:
    pat = dmrs_mod.dmrs_pattern(1, cfg.nof_prb, port=0)
    sc0 = cfg.start_prb * N_SC_PER_PRB
    wf = torch.as_tensor(pat.wf, device=device)
    return GridLayout(
        data_symbols=torch.as_tensor(np.asarray(cfg.data_symbols, np.int64),
                                     device=device),
        pilot_sc=torch.as_tensor(pat.subcarriers + sc0, device=device),
        wf=wf,
        pilots=tuple(pilot_values(cfg, l, pat, device) * wf
                     for l in cfg.dmrs_symbols))


def map_to_grid(symbols: torch.Tensor, cfg: PdschConfig, nsymb: int,
                nsubc: int, amplitude: float = 1.0,
                dmrs_scale: float = 1.0) -> torch.Tensor:
    """(1, nof_data_re) symbols -> (nsymb, nsubc) grid contribution.

    Frequency-first mapping across the allocation, symbols in time order,
    plus the DM-RS pilots on the configured symbols.  ``dmrs_scale`` is the
    DM-RS-to-data amplitude ratio: 1.0 for the DL (0 dB EPRE ratios); the
    PUSCH paths pass sqrt(2), the TS 38.214 3 dB boost for 2 CDM groups
    without data that the reference receiver assumes."""
    dev = symbols.device
    lay = grid_layout(cfg, dev)
    sc0 = cfg.start_prb * N_SC_PER_PRB
    width = cfg.nof_prb * N_SC_PER_PRB
    grid = torch.zeros((nsymb, nsubc), dtype=torch.complex64, device=dev)
    data = symbols.reshape(len(cfg.data_symbols), width) \
        * float(np.float32(amplitude))
    grid[lay.data_symbols, sc0:sc0 + width] = data.to(torch.complex64)
    scale = float(np.float32(amplitude * dmrs_scale))
    for l, pil in zip(cfg.dmrs_symbols, lay.pilots):
        grid[l, lay.pilot_sc] = pil * scale
    return grid


def process(payload: torch.Tensor, cfg: PdschConfig, nsymb: int, nsubc: int,
            rv: int = 0, amplitude: float = 1.0) -> torch.Tensor:
    """Full PDSCH: (1, TBS) payload -> (nsymb, nsubc) grid contribution."""
    bits = encode_transport_block(payload, cfg, rv)
    syms = modulation.modulate(bits, cfg.modulation)
    if cfg.transform_precoding:
        syms = precoding.transform_precode(syms, cfg.nof_prb * N_SC_PER_PRB)
    return map_to_grid(syms, cfg, nsymb, nsubc, amplitude)


def receive(rx_grid: torch.Tensor, cfg: PdschConfig, srate: float,
            symbol_times: np.ndarray, rv: int = 0,
            soft_buffer: torch.Tensor | None = None,
            num_iters: int | None = None, scs_hz: float = 15e3,
            delay_spread_s: float | None = None):
    """UE-side PDSCH receiver: (nsymb, nsubc) rx grid -> PuschResult.

    The same estimate -> MMSE -> demap -> descramble -> dematch -> LDPC chain
    as the gNB PUSCH receiver, with the DL DM-RS conventions: no 3 dB DM-RS
    boost and no UCI.  HARQ combining uses ``soft_buffer`` / ``rv`` as in
    the UL."""
    from . import pusch
    kw = {} if num_iters is None else {"num_iters": num_iters}
    return pusch.process(rx_grid, cfg, srate, symbol_times, rv=rv,
                         soft_buffer=soft_buffer, scs_hz=scs_hz,
                         delay_spread_s=delay_spread_s, uci=None,
                         dmrs_beta=1.0, **kw)
