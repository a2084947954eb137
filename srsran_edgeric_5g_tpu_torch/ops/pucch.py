"""PUCCH formats 0, 1 and 2 (TS 38.211 §6.3.2, §6.4.1.3, TS 38.213 §9.2).

Port of ``srsran_edgeric_5g_tpu/ops/pucch.py`` (the reference's
pucch_detector_format0/1, pucch_demodulator_impl and pucch_processor_impl):

  * Format 0: sequence selection on one PRB; detection correlates the
    received REs against every cyclic-shift hypothesis at once.
  * Format 1: base sequence with time-domain OCC spreading and BPSK/QPSK
    data on the odd symbol offsets, DM-RS on the even ones; detection
    despreads across symbols, then correlates.
  * Format 2: QPSK data + DM-RS on subcarriers 3k+1; receive = LS estimate
    from its DM-RS, MMSE, demap, descramble, then short-block or polar UCI
    decode (ops.uci).

Group hopping is 'neither': u = n_ID mod 30, v = 0.  The cyclic-shift
hopping table n_cs(ns, l), the sequences and the OCC are host constants;
the full cell builds its batched F1 / F2 rows from the same tables.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import resolve_device
from . import uci as uci_ops
from .equalizer import equalize_mmse_1xn
from .low_papr import base_sequence
from .modulation import demodulate_soft, modulate
from .sequences import np_gold_sequence, scramble_bits, scramble_llrs

NSC = 12


@dataclasses.dataclass(frozen=True)
class Pucch01Config:
    n_id: int          # hopping id (cell id by default)
    slot: int
    start_symbol: int
    nof_symbols: int   # 1-2 (F0), 4-14 (F1)
    initial_cs: int
    prb: int = 0       # PRB offset of the single-PRB allocation

    @property
    def u(self) -> int:
        return self.n_id % 30


@functools.lru_cache(maxsize=None)
def _ncs_table(n_id: int, slot: int) -> np.ndarray:
    """n_cs(ns, l) for all 14 symbols (TS 38.211 §6.3.2.2.2)."""
    c = np_gold_sequence(n_id, 8 * 14 * (slot + 1))
    base = 8 * 14 * slot
    out = np.zeros(14, dtype=np.int64)
    for l in range(14):
        bits = c[base + 8 * l: base + 8 * l + 8]
        out[l] = int((bits * (1 << np.arange(8))).sum())
    return out


def _f0_sequence(cfg: Pucch01Config, m0: int, symbol: int) -> np.ndarray:
    ncs = _ncs_table(cfg.n_id, cfg.slot)[symbol]
    alpha = 2.0 * np.pi / NSC * ((m0 + ncs) % NSC)
    base = base_sequence(cfg.u, 0, NSC)
    n = np.arange(NSC)
    return (np.exp(1j * alpha * n) * base).astype(np.complex64)


def _occ(n: int, i: int) -> np.ndarray:
    """F1 time-domain OCC w_i(m) = e^{j 2 pi i m / N_SF} (Table
    6.3.2.4.1-2)."""
    k = np.arange(n)
    return np.exp(2j * np.pi * i * k / n).astype(np.complex64)


def _f0_rows(cfg: Pucch01Config, m0: int) -> np.ndarray:
    return np.stack([_f0_sequence(cfg, m0, cfg.start_symbol + i)
                     for i in range(cfg.nof_symbols)])


def format0_generate(cfg: Pucch01Config, m0: int,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """(nof_symbols, 12) sequence REs for initial cyclic shift m0."""
    return torch.as_tensor(_f0_rows(cfg, m0), device=resolve_device(device))


def format0_detect(rx: torch.Tensor, cfg: Pucch01Config,
                   m0_candidates: tuple[int, ...]
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Correlate (nof_symbols, 12) rx REs against m0 hypotheses: (metrics
    (len(cands),), best index).  The caller maps m0 to HARQ-ACK / SR values
    (TS 38.213 §9.2.3 / §9.2.5)."""
    cands = torch.as_tensor(np.stack([_f0_rows(cfg, m0) for m0 in m0_candidates]),
                            device=rx.device)
    corr = torch.sum(rx[None] * cands.conj(), dim=(-2, -1)).abs()
    energy = torch.sqrt(torch.sum(rx.abs() ** 2) + 1e-30)
    metrics = corr / (energy * float(np.sqrt(NSC * cfg.nof_symbols)))
    return metrics, torch.argmax(metrics)


def _f1_symbol(bits) -> complex:
    """1 bit -> BPSK on the diagonal, 2 bits -> QPSK."""
    if len(bits) == 1:
        return (1 - 2 * int(bits[0])) / np.sqrt(2) * (1 + 1j)
    return ((1 - 2 * int(bits[0])) + 1j * (1 - 2 * int(bits[1]))) / np.sqrt(2)


def _f1_data_rows(cfg: Pucch01Config, bits, occ_index: int) -> np.ndarray:
    nof_data = cfg.nof_symbols // 2
    d, w = _f1_symbol(bits), _occ(nof_data, occ_index)
    return np.stack([d * w[m] * _f0_sequence(cfg, cfg.initial_cs,
                                             cfg.start_symbol + 2 * m + 1)
                     for m in range(nof_data)]).astype(np.complex64)


def _f1_dmrs_rows(cfg: Pucch01Config, occ_index: int) -> np.ndarray:
    nof_dmrs = (cfg.nof_symbols + 1) // 2
    w = _occ(nof_dmrs, occ_index)
    return np.stack([w[m] * _f0_sequence(cfg, cfg.initial_cs,
                                         cfg.start_symbol + 2 * m)
                     for m in range(nof_dmrs)]).astype(np.complex64)


def format1_generate(cfg: Pucch01Config, bits, occ_index: int = 0,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """F1 data rows d * w_i(m) * r^(alpha)(n) at the odd symbol offsets (TS
    38.211 §6.3.2.4.1; the DM-RS rides the even offsets, format1_dmrs)."""
    return torch.as_tensor(_f1_data_rows(cfg, bits, occ_index),
                           device=resolve_device(device))


def format1_dmrs(cfg: Pucch01Config, occ_index: int = 0,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """F1 DM-RS rows w_i(m) * r^(alpha)(n) at the even symbol offsets (TS
    38.211 §6.4.1.3.1, N_SF^DMRS = ceil(nof_symbols / 2))."""
    return torch.as_tensor(_f1_dmrs_rows(cfg, occ_index),
                           device=resolve_device(device))


def format1_process(bits, cfg: Pucch01Config, nsymb: int, nsubc: int,
                    occ_index: int = 0, device: str | torch.device = "cuda"
                    ) -> torch.Tensor:
    """Full F1 occasion -> (nsymb, nsubc) grid contribution (data + DM-RS)."""
    dev = resolve_device(device)
    data = format1_generate(cfg, bits, occ_index, dev)
    dmrs = format1_dmrs(cfg, occ_index, dev)
    sc0 = cfg.prb * NSC
    grid = torch.zeros((nsymb, nsubc), dtype=torch.complex64, device=dev)
    l0 = cfg.start_symbol
    grid[l0:l0 + 2 * dmrs.shape[0]:2, sc0:sc0 + NSC] = dmrs
    grid[l0 + 1:l0 + 1 + 2 * data.shape[0]:2, sc0:sc0 + NSC] = data
    return grid


def format1_detect(rx_data: torch.Tensor, cfg: Pucch01Config, nof_bits: int,
                   occ_index: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Despread + correlate: (nof_data_symbols, 12) rx rows (the odd symbol
    offsets of the occasion) -> (bits, |metric|)."""
    nof_data = rx_data.shape[0]
    dev = rx_data.device
    w = torch.as_tensor(_occ(nof_data, occ_index), device=dev)
    seqs = torch.as_tensor(np.stack([
        _f0_sequence(cfg, cfg.initial_cs, cfg.start_symbol + 2 * m + 1)
        for m in range(nof_data)]), device=dev)
    z = torch.sum(rx_data * seqs.conj() * w.conj()[:, None], dim=(0, 1)) \
        / (nof_data * NSC)
    if nof_bits == 1:
        bits = (z.real + z.imag < 0).reshape(1)
    else:
        bits = torch.stack([z.real < 0, z.imag < 0])
    return bits.to(torch.int8), z.abs()


@dataclasses.dataclass(frozen=True)
class Pucch2Config:
    rnti: int
    n_id: int          # scrambling id
    n_id0: int         # DM-RS scrambling id
    slot: int
    start_symbol: int
    nof_symbols: int   # 1-2
    start_prb: int
    nof_prb: int
    uci_bits: int

    @property
    def data_sc_per_prb(self) -> int:
        return 8  # 12 minus 4 DM-RS (subcarriers 3k+1)

    @property
    def e_total(self) -> int:
        return 2 * self.data_sc_per_prb * self.nof_prb * self.nof_symbols


def _f2_data_sc(nof_prb: int) -> np.ndarray:
    """Data subcarriers within the allocation (all except 3k+1)."""
    sc = np.arange(NSC * nof_prb)
    return sc[sc % 3 != 1]


def _f2_dmrs_sc(nof_prb: int) -> np.ndarray:
    sc = np.arange(NSC * nof_prb)
    return sc[sc % 3 == 1]


def _f2_dmrs_cinit(cfg: Pucch2Config, symbol: int) -> int:
    return ((1 << 17) * (14 * cfg.slot + symbol + 1) * (2 * cfg.n_id0 + 1)
            + 2 * cfg.n_id0) % (1 << 31)


def _f2_pilots(cfg: Pucch2Config, symbol: int) -> np.ndarray:
    """F2 DM-RS values of one symbol (the allocation's slice of the Gold QPSK
    sequence)."""
    npil = len(_f2_dmrs_sc(cfg.nof_prb))
    c = np_gold_sequence(_f2_dmrs_cinit(cfg, symbol), 2 * (npil + 4 * cfg.start_prb))
    c = c[8 * cfg.start_prb:]
    pil = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)
    return pil[:npil].astype(np.complex64)


def _f2_c_init(cfg: Pucch2Config, device: torch.device) -> torch.Tensor:
    return torch.as_tensor([(cfg.rnti << 15) + cfg.n_id], dtype=torch.int64,
                           device=device)


def format2_uci_encode(bits: torch.Tensor, cfg: Pucch2Config) -> torch.Tensor:
    """(1, K) UCI bits -> (1, E) coded bits (ops.uci: short block K <= 11;
    polar with CRC6 + PC for 12 <= K <= 19, CRC11 for K >= 20)."""
    return uci_ops.encode(bits, cfg.e_total)


def format2_process(payload_bits: torch.Tensor, cfg: Pucch2Config,
                    nsymb: int, nsubc: int) -> torch.Tensor:
    """UCI bits -> (nsymb, nsubc) grid contribution (data + DM-RS)."""
    dev = payload_bits.device
    coded = format2_uci_encode(payload_bits, cfg)
    syms = modulate(scramble_bits(coded, _f2_c_init(cfg, dev)), "qpsk"
                    ).reshape(cfg.nof_symbols, -1)
    sc0 = cfg.start_prb * NSC
    data_sc = torch.as_tensor(_f2_data_sc(cfg.nof_prb) + sc0, device=dev)
    dmrs_sc = torch.as_tensor(_f2_dmrs_sc(cfg.nof_prb) + sc0, device=dev)
    grid = torch.zeros((nsymb, nsubc), dtype=torch.complex64, device=dev)
    for i in range(cfg.nof_symbols):
        l = cfg.start_symbol + i
        grid[l, data_sc] = syms[i]
        grid[l, dmrs_sc] = torch.as_tensor(_f2_pilots(cfg, l), device=dev)
    return grid


def format2_decode(rx_grid: torch.Tensor, cfg: Pucch2Config
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(nsymb, nsubc) rx grid -> ((1, K) UCI bits, (1,) CRC / detection ok).

    Per-symbol LS estimate at the F2 DM-RS, averaged over the symbols,
    nearest-pilot interpolation (pilot spacing 3), MMSE 1x1, QPSK demap,
    descramble, UCI decode."""
    dev = rx_grid.device
    sc0 = cfg.start_prb * NSC
    data_sc = torch.as_tensor(_f2_data_sc(cfg.nof_prb) + sc0, device=dev)
    dmrs_sc = torch.as_tensor(_f2_dmrs_sc(cfg.nof_prb) + sc0, device=dev)
    h_syms = torch.stack([
        rx_grid[cfg.start_symbol + i, dmrs_sc]
        * torch.as_tensor(_f2_pilots(cfg, cfg.start_symbol + i), device=dev).conj()
        for i in range(cfg.nof_symbols)])
    h_p = torch.mean(h_syms, dim=0)                         # (npil,)
    if cfg.nof_symbols >= 2:
        r = h_syms - h_p[None]
        noise_var = torch.mean(r.abs() ** 2) * (cfg.nof_symbols
                                                / (cfg.nof_symbols - 1))
    else:
        d = h_p[1:] - h_p[:-1]
        noise_var = torch.mean(d.abs() ** 2) / 2.0
    # A noiseless grid estimates exactly 0 here, which the MMSE's
    # abnormal-input rule turns into an erasure of every RE.  The reference
    # escapes that only through the round-off of its fused complex products
    # (a variance near 1e-16); the floor is float32 round-off of the channel
    # power, far below any noise a real grid carries.
    floor = torch.mean(h_p.abs() ** 2) * float(np.finfo(np.float32).eps) ** 2
    noise_var = torch.maximum(noise_var, floor)

    pilots_pos = _f2_dmrs_sc(cfg.nof_prb)
    data_pos = _f2_data_sc(cfg.nof_prb)
    nearest = np.abs(data_pos[:, None] - pilots_pos[None, :]).argmin(axis=1)
    h_data = h_p[torch.as_tensor(nearest, device=dev)]      # (ndata,)

    y = rx_grid[cfg.start_symbol:cfg.start_symbol + cfg.nof_symbols][:, data_sc]
    hh = h_data.expand(y.shape)
    nv = noise_var.expand(y.shape)
    xh, nvo = equalize_mmse_1xn(y[None], hh[None], nv[None])
    llr = demodulate_soft(xh.reshape(1, -1), nvo.reshape(1, -1), "qpsk",
                          quantize=False)
    llr = scramble_llrs(llr, _f2_c_init(cfg, dev))
    return uci_ops.decode(llr, cfg.uci_bits, cfg.e_total)
