"""Full gNB slot pipeline: every per-slot channel of the cell in one DL and
one UL slot-batch call.

Port of ``srsran_edgeric_5g_tpu/parallel/full_cell.py``.

  DL TX (``gnb_dl_slot_batch``):
    * PDSCH for all UEs (the slot pipeline's coding front-end, DM-RS 0 dB);
    * a PDCCH CORESET on symbol 0 with 2 DCIs per UE per slot, all S*2U DCIs
      polar-encoded as one batch;
    * the SS/PBCH block on its occasions (those slots move their PDSCH to
      symbols 6..13), all PBCH payloads polar-encoded as one batch;
    * NZP-CSI-RS rows on their occasions;
    * one OFDM modulation of the merged slot batch, then the TX amplitude
      controller.

  UE UL TX (``ue_ul_slot_batch``): the UE-side generator — PUSCH + PUCCH F1
    HARQ-ACK every slot + PUCCH F2 CSI, SRS and PRACH on their occasions.

  UL RX (``gnb_ul_slot_batch``): one OFDM demodulation shared by PUSCH
    (with the int8 HARQ soft carry; the decode runs the CUDA kernel on the
    card), PUCCH F1 detection, PUCCH F2 decode, SRS snapshots and PRACH
    detection.

The reference's TPU workarounds are written in PyTorch's plain idiom: slot
occasion selection and re-interleaving are strided slices, and the PRACH
correlation's prime-length (839) IDFT is ``torch.fft.ifft`` instead of an
IDFT matmul.  Host constants (pilots, sequences, mappings) are built once
per (config, S) in numpy and cached as device tensors per device, so a
step copies nothing from the host.

The MIMO variants (``gnb_dl_slot_batch_mimo``, ``ue_ul_slot_batch_mimo``,
``gnb_ul_slot_batch_mimo``) run PDSCH/PUSCH at ``n_layers`` layers through
the slot pipeline's ``*_mimo`` programs; the control channels (PDCCH, SSB
and CSI-RS down, PUCCH, SRS and PRACH up) stay single-port on port /
antenna 0.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import resolve_device
from ..models import pdcch as pdcch_mod, ssb as ssb_mod
from ..ops import amplitude, csi_rs, modulation, ofdm, prach as prach_mod
from ..ops import pucch as pucch_mod, sequences, short_block, sync_signals
from ..ops.crc import crc, crc_attach
from ..ops.ldpc import decoder
from ..ops.polar import encoder as penc, rate_match as prm
from ..ran.numerology import N_SC_PER_PRB
from . import slot_pipeline as sp

SQRT2 = float(np.sqrt(2.0))


def _slot_slice(idx: np.ndarray) -> slice:
    """The slot-axis slice of an occasion set: every set here is an
    arithmetic progression (offset::period)."""
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size == 0:
        return slice(0, 0)
    step = int(idx[1] - idx[0]) if idx.size > 1 else 1
    if step <= 0 or not (np.diff(idx) == step).all():
        raise ValueError(f"occasion slots {idx} are not offset::period")
    return slice(int(idx[0]), int(idx[-1]) + 1, step)


def _slot_take(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """x[idx] along the slot axis, as a strided slice."""
    return x[_slot_slice(idx)]


def _slot_drop_period(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[i] for i % k != 0 (the complement of the period-k occasions at
    offset 0): a reshape and a slice."""
    n, rest = x.shape[0], x.shape[1:]
    nb = n // k
    head = x[:nb * k].reshape(nb, k, *rest)[:, 1:].reshape(nb * (k - 1), *rest)
    return head if n == nb * k else torch.cat([head, x[nb * k + 1:]])


def _slot_merge_period(x_occ: torch.Tensor, x_norm: torch.Tensor, k: int,
                       s_total: int) -> torch.Tensor:
    """Re-interleave the period-k occasion slots (i % k == 0) and their
    complement back to slot order."""
    rest = x_norm.shape[1:]
    nb = s_total // k
    out = x_norm.new_empty((s_total, *rest))
    out[0::k] = x_occ
    out[:nb * k].view(nb, k, *rest)[:, 1:] = \
        x_norm[:nb * (k - 1)].reshape(nb, k - 1, *rest)
    out[nb * k + 1:] = x_norm[nb * (k - 1):]
    return out


@dataclasses.dataclass(frozen=True)
class FullCellConfig:
    """Static full-cell geometry + control-channel periodicities (the same
    fields as the reference's FullCellConfig; ``convert.full_cell_from_dict``
    carries one across)."""

    nof_prb: int = 106
    nfft: int = 1536
    nof_ue: int = 4
    mu: int = 0
    pci: int = 1
    n_id: int = 1
    # PDSCH (DL data)
    dl_first_prb: int = 2
    dl_prb_per_ue: int = 25
    dl_modulation: str = "qam64"
    dl_target_rate: float = 0.5
    # PUSCH (UL data)
    ul_first_prb: int = 4
    ul_prb_per_ue: int = 24
    ul_modulation: str = "qam64"
    ul_target_rate: float = 0.5
    # PDCCH: 2 DCIs (DL + UL grant) per UE per slot, one CORESET
    dci_bits: int = 40
    pdcch_al: int = 2
    coreset_start_prb: int = 2
    coreset_nof_prb: int = 96
    # SSB (slots = 0 mod ssb_period)
    ssb_period: int = 10
    ssb_first_subcarrier: int = 516
    # NZP-CSI-RS occasions: full-BWP density-1 row on csi_rs_symbol
    csi_rs_period: int = 10
    csi_rs_offset: int = 2
    csi_rs_symbol: int = 1
    # PUCCH F2 CSI occasions
    csi_period: int = 5
    csi_offset: int = 1
    csi_bits: int = 8
    # SRS occasions (symbol 13, comb 4, per-UE comb offset)
    srs_period: int = 10
    srs_offset: int = 3
    # PRACH occasions (format 0, long preamble)
    prach_period: int = 10
    prach_offset: int = 5
    prach_root: int = 1
    prach_ncs: int = 13
    prach_freq_prb: int = 100
    # Peak-to-floor detection threshold (prach_detector_generic_thresholds).
    prach_threshold: float = 20.0
    # TX amplitude controller: ceiling 0 = scale mode.
    tx_gain: float = 1.0
    tx_ceiling: float = 0.0
    # Spatial layers per UE of PDSCH/PUSCH (> 1: the *_mimo entry points).
    n_layers: int = 1
    # PUSCH channel estimator: 0 = LS + interpolation, > 0 = TA + smoothing
    # over this delay spread.
    ul_delay_spread_us: float = 0.0

    # ------------------------------------------------------- derived cells

    def dl_cell(self) -> sp.CellConfig:
        return sp.CellConfig(
            nof_prb=self.nof_prb, nfft=self.nfft, nof_ue=self.nof_ue,
            prb_per_ue=self.dl_prb_per_ue, modulation=self.dl_modulation,
            target_rate=self.dl_target_rate, first_symbol=2, nof_symbols=12,
            dmrs_symbols=(2, 11), n_id=self.n_id, mu=self.mu,
            first_prb=self.dl_first_prb)

    def dl_cell_ssb(self) -> sp.CellConfig:
        """PDSCH shape on SSB slots: symbols 6..13 (SSB owns 2..5)."""
        return dataclasses.replace(self.dl_cell(), first_symbol=6,
                                   nof_symbols=8, dmrs_symbols=(6, 11))

    def ul_cell(self) -> sp.CellConfig:
        return sp.CellConfig(
            nof_prb=self.nof_prb, nfft=self.nfft, nof_ue=self.nof_ue,
            prb_per_ue=self.ul_prb_per_ue, modulation=self.ul_modulation,
            target_rate=self.ul_target_rate, first_symbol=0, nof_symbols=13,
            dmrs_symbols=(2, 11), n_id=self.n_id, mu=self.mu,
            first_prb=self.ul_first_prb, n_layers=self.n_layers,
            delay_spread_us=self.ul_delay_spread_us)

    def dl_cell_mimo(self) -> sp.CellConfig:
        return dataclasses.replace(self.dl_cell(), n_layers=self.n_layers)

    def dl_cell_ssb_mimo(self) -> sp.CellConfig:
        return dataclasses.replace(self.dl_cell_ssb(), n_layers=self.n_layers)

    @property
    def timing(self):
        return self.dl_cell().timing

    def rntis(self) -> np.ndarray:
        return (0x4601 + np.arange(self.nof_ue)).astype(np.int64)

    # ------------------------------------------------ slot classification

    def ssb_slots(self, s: int) -> np.ndarray:
        return np.arange(0, s, self.ssb_period)

    def norm_slots(self, s: int) -> np.ndarray:
        return np.asarray([i for i in range(s) if i % self.ssb_period != 0])

    def csi_slots(self, s: int) -> np.ndarray:
        return np.asarray([i for i in range(s)
                           if i % self.csi_period == self.csi_offset])

    def srs_slots(self, s: int) -> np.ndarray:
        return np.asarray([i for i in range(s)
                           if i % self.srs_period == self.srs_offset])

    def prach_slots(self, s: int) -> np.ndarray:
        return np.asarray([i for i in range(s)
                           if i % self.prach_period == self.prach_offset])

    def csi_rs_slots(self, s: int) -> np.ndarray:
        if self.csi_rs_period <= 0:
            return np.asarray([], dtype=np.int64)
        return np.asarray([i for i in range(s)
                           if i % self.csi_rs_period == self.csi_rs_offset])

    def csi_rs_cfg(self, slot: int) -> csi_rs.CsiRsConfig:
        return csi_rs.CsiRsConfig(scrambling_id=self.pci, slot=slot,
                                  symbol=self.csi_rs_symbol, start_prb=0,
                                  nof_prb=self.nof_prb)

    # ------------------------------------------------------- sub-configs

    def pdcch_cfgs(self) -> list[pdcch_mod.PdcchConfig]:
        """2 DCIs per UE (DL grant, UL grant), consecutive CCEs."""
        return [pdcch_mod.PdcchConfig(
            rnti=0x4601 + (i % self.nof_ue), n_id=self.n_id,
            aggregation_level=self.pdcch_al, cce_index=i * self.pdcch_al,
            start_symbol=0, coreset_start_prb=self.coreset_start_prb,
            coreset_nof_prb=self.coreset_nof_prb, duration=1,
            payload_bits=self.dci_bits) for i in range(2 * self.nof_ue)]

    def pucch_f2_cfg(self, ue: int, slot: int = 0) -> pucch_mod.Pucch2Config:
        return pucch_mod.Pucch2Config(
            rnti=0x4601 + ue, n_id=self.n_id, n_id0=self.n_id, slot=slot,
            start_symbol=0, nof_symbols=2, start_prb=self.prach_freq_prb + ue,
            nof_prb=1, uci_bits=self.csi_bits)

    def srs_cfg(self, ue: int) -> csi_rs.SrsConfig:
        return csi_rs.SrsConfig(
            sequence_id=self.pci, slot=0, symbol=13,
            start_prb=self.ul_first_prb,
            nof_prb=self.nof_ue * self.ul_prb_per_ue,
            comb=4, comb_offset=ue, cyclic_shift=0)

    def prach_cfg(self) -> prach_mod.PrachConfig:
        return prach_mod.PrachConfig(root_sequence_index=self.prach_root,
                                     zero_correlation_zone=self.prach_ncs)

    def prach_info(self) -> prach_mod.PrachOfdmInfo:
        t = self.timing
        # PRB prach_freq_prb relative to baseband DC (grid subcarrier k maps
        # to (k - nof_subc/2) * scs).
        off_hz = (self.prach_freq_prb * N_SC_PER_PRB
                  - t.nof_subc // 2) * 15e3 * (1 << self.mu)
        return prach_mod.prach_ofdm_info(int(t.srate), freq_offset_hz=off_hz)


def _dev(*arrays, device):
    """numpy host constants -> tensors on ``device``."""
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in arrays)


# ============================================================ DL control

@functools.lru_cache(maxsize=None)
def _pdcch_static(fc: FullCellConfig, s_total: int):
    """Static PDCCH mapping: (cfgs, data_sc, dmrs_sc, per-slot DM-RS values,
    per-DCI scrambling inits, per-DCI RNTI CRC masks)."""
    cfgs = fc.pdcch_cfgs()
    pos = [pdcch_mod._re_positions(c) for c in cfgs]
    data_sc = np.concatenate([p[0] for p in pos])
    if len(np.unique(data_sc)) != len(data_sc):
        raise ValueError("overlapping PDCCH CCEs")
    dmrs_sc = np.unique(np.concatenate([p[1] for p in pos]))
    dmrs_vals = np.stack([
        pdcch_mod._dmrs_values(dataclasses.replace(cfgs[0], slot=sl), dmrs_sc, 0)
        for sl in range(s_total)])                          # (S, ndmrs)
    ci = np.asarray([pdcch_mod._scrambling_cinit(c) for c in cfgs], np.int64)
    rnti_mask = np.asarray([[(c.rnti >> (15 - i)) & 1 for i in range(16)]
                            for c in cfgs], np.int8)
    return cfgs, data_sc, dmrs_sc, dmrs_vals, ci, rnti_mask


@functools.lru_cache(maxsize=None)
def _pdcch_tensors(fc: FullCellConfig, s_total: int, device: torch.device):
    _, data_sc, dmrs_sc, dmrs_vals, ci, rnti_mask = _pdcch_static(fc, s_total)
    return _dev(data_sc, dmrs_sc, dmrs_vals, np.tile(ci, s_total),
                np.tile(rnti_mask, (s_total, 1)), device=device)


def pdcch_rows(dci: torch.Tensor, fc: FullCellConfig,
               s_total: int) -> torch.Tensor:
    """(S, NDCI, A) DCI payloads -> (S, nsubc) CORESET symbol rows.

    All S*NDCI DCIs go through one CRC24C + RNTI mask -> polar -> rate match
    -> scramble -> QPSK chain; the DM-RS values are per-slot host constants.
    """
    cfgs = _pdcch_static(fc, s_total)[0]
    data_sc, dmrs_sc, dmrs_vals, ci, mask = _pdcch_tensors(fc, s_total,
                                                           dci.device)
    s, ndci, a = dci.shape
    if s != s_total or ndci != len(cfgs):
        raise ValueError(f"DCIs {tuple(dci.shape)} for S={s_total}, "
                         f"{len(cfgs)} DCIs per slot")
    code = pdcch_mod._polar(cfgs[0])
    pay = dci.reshape(s * ndci, a).to(torch.int8)
    ones = torch.ones((s * ndci, 24), dtype=torch.int8, device=dci.device)
    crc_bits = crc(torch.cat([ones, pay], dim=1), "crc24c")
    crc_bits = torch.cat([crc_bits[:, :8], crc_bits[:, 8:] ^ mask], dim=1)
    cw = penc.encode(torch.cat([pay, crc_bits], dim=1), code)
    bits = prm.rate_match(cw, code)                          # (S*NDCI, E)
    syms = modulation.modulate(sequences.scramble_bits(bits, ci), "qpsk")
    rows = torch.zeros((s, fc.timing.nof_subc), dtype=torch.complex64,
                       device=dci.device)
    rows[:, data_sc] = syms.reshape(s, -1)
    rows[:, dmrs_sc] = dmrs_vals
    return rows


@functools.lru_cache(maxsize=None)
def _ssb_static(fc: FullCellConfig, s_total: int):
    """Static SSB machinery for the batch's occasions (sfn0 = 0): payload
    positions, per-occasion timing bits and 1st scrambling, PBCH data
    positions, the static PSS/SSS/DM-RS block, the 2nd scrambling."""
    slots_per_frame = 10 * (1 << fc.mu)
    cfgs = [ssb_mod.SsbConfig(pci=fc.pci, ssb_index=0, l_max=4, hrf=False,
                              sfn=int(sl) // slots_per_frame)
            for sl in fc.ssb_slots(s_total)]
    maps = [ssb_mod._payload_maps(c) for c in cfgs]
    pos, epos = maps[0][0], maps[0][1]
    evals = np.stack([m[2] for m in maps])                  # (N, n_extra)
    seq1 = np.stack([m[3] for m in maps])                   # (N, 32)
    _, data_pos, dmrs_pos = ssb_mod._pbch_positions(cfgs[0])
    base = np.zeros((4, 240), np.complex64)
    n_id1, n_id2 = sync_signals.pci_to_nid(fc.pci)
    base[0, 56:56 + 127] = sync_signals.pss_sequence(n_id2)
    base[2, 56:56 + 127] = sync_signals.sss_sequence(n_id1, n_id2)
    base[dmrs_pos[:, 0], dmrs_pos[:, 1]] = \
        ssb_mod._dmrs_sequence(cfgs[0], len(dmrs_pos))
    seq2 = ssb_mod._seq2(cfgs[0])
    return pos, epos, evals, seq1, data_pos, base, seq2


@functools.lru_cache(maxsize=None)
def _ssb_tensors(fc: FullCellConfig, s_total: int, device: torch.device):
    pos, epos, evals, seq1, data_pos, base, seq2 = _ssb_static(fc, s_total)
    return _dev(pos, epos, evals, seq1, data_pos[:, 0], data_pos[:, 1], base,
                seq2, device=device)


def ssb_blocks(pbch: torch.Tensor, fc: FullCellConfig,
               s_total: int) -> torch.Tensor:
    """(N_occ, 24) MIB payloads -> (N_occ, 4, 240) SSB blocks: one batched
    §7.1.1 chain (payload interleave + timing bits + 1st scrambling ->
    CRC24C -> polar -> 2nd scrambling -> QPSK); PSS/SSS/DM-RS are static."""
    pos, epos, evals, seq1, dsym, dsc, base, seq2 = _ssb_tensors(
        fc, s_total, pbch.device)
    n = pbch.shape[0]
    a = torch.zeros((n, ssb_mod.PBCH_A), dtype=torch.int8, device=pbch.device)
    a[:, pos] = pbch.to(torch.int8)
    a[:, epos] = evals
    a = a ^ seq1
    code = ssb_mod._polar()
    bits = prm.rate_match(penc.encode(crc_attach(a, "crc24c"), code), code)
    syms = modulation.modulate(bits ^ seq2, "qpsk")          # (N, 432)
    blocks = base.expand(n, 4, 240).clone()
    blocks[:, dsym, dsc] = syms
    return blocks


@functools.lru_cache(maxsize=None)
def _csi_rs_rows_np(fc: FullCellConfig, s_total: int) -> np.ndarray:
    """(S, nsubc) NZP-CSI-RS contribution of each slot's csi_rs_symbol
    (zeros off-occasion)."""
    rows = np.zeros((s_total, fc.timing.nof_subc), np.complex64)
    for sl in fc.csi_rs_slots(s_total):
        c = fc.csi_rs_cfg(int(sl))
        rows[sl, csi_rs.csi_rs_subcarriers(c)] = csi_rs.csi_rs_pilots(c)
    return rows


@functools.lru_cache(maxsize=None)
def _csi_rs_rows(fc: FullCellConfig, s_total: int, device: torch.device):
    return _dev(_csi_rs_rows_np(fc, s_total), device=device)[0]


@functools.lru_cache(maxsize=None)
def _rntis(fc: FullCellConfig, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(fc.rntis(), device=device)


def gnb_dl_slot_batch(pay_norm, pay_ssb, dci, pbch, fc: FullCellConfig,
                      s_total: int, device: str | torch.device = "cuda"
                      ) -> torch.Tensor:
    """Full DL slot batch -> (S, total) complex64 baseband samples.

    pay_norm: (S_norm, U, TBS_dl) PDSCH payloads of the non-SSB slots;
    pay_ssb: (S_ssb, U, TBS_dl_ssb) payloads of the SSB slots (shorter
    PDSCH); dci: (S, 2U, A) DCI payloads; pbch: (S_ssb, 24) MIB payloads.
    """
    dev = resolve_device(device)
    pay_norm, pay_ssb, dci, pbch = (torch.as_tensor(x, device=dev)
                                    for x in (pay_norm, pay_ssb, dci, pbch))
    cell_n, cell_s = fc.dl_cell(), fc.dl_cell_ssb()
    t = cell_n.timing
    norm_idx, ssb_idx = fc.norm_slots(s_total), fc.ssb_slots(s_total)
    if ssb_idx[0] != 0:
        raise ValueError("the SSB occasions must start at slot 0")
    rntis = _rntis(fc, dev)
    u, k = fc.nof_ue, fc.ssb_period

    syms_n = sp._dl_code(pay_norm.reshape(len(norm_idx) * u, -1), rntis,
                         cell_n).reshape(len(norm_idx), u, -1)
    syms_s = sp._dl_code(pay_ssb.reshape(len(ssb_idx) * u, -1), rntis,
                         cell_s).reshape(len(ssb_idx), u, -1)
    prows = pdcch_rows(dci, fc, s_total)                    # (S, nsubc)
    blocks = ssb_blocks(pbch, fc, s_total)                  # (S_ssb, 4, 240)

    rows_n = {0: _slot_drop_period(prows, k)}
    rows_s = {0: prows[0::k]}
    if fc.csi_rs_period > 0:
        crows = _csi_rs_rows(fc, s_total, dev)
        rows_n[fc.csi_rs_symbol] = _slot_drop_period(crows, k)
        rows_s[fc.csi_rs_symbol] = crows[0::k]
    sc0 = fc.ssb_first_subcarrier
    for j in range(4):
        row = torch.zeros((len(ssb_idx), t.nof_subc), dtype=torch.complex64,
                          device=dev)
        row[:, sc0:sc0 + 240] = blocks[:, j]
        rows_s[2 + j] = rows_s[2 + j] + row if 2 + j in rows_s else row
    g_n = sp._dl_grid(syms_n, cell_n, dmrs_scale=1.0, add_rows=rows_n)
    g_s = sp._dl_grid(syms_s, cell_s, dmrs_scale=1.0, add_rows=rows_s)
    grid = _slot_merge_period(g_s, g_n, k, s_total)
    td = ofdm.modulate_slot(grid, t, scale=1.0 / t.nfft)
    if fc.tx_ceiling > 0:
        td, _ = amplitude.clip(td, fc.tx_gain, fc.tx_ceiling)
    else:
        td, _ = amplitude.scale(td, fc.tx_gain)
    return td


# ============================================================ PUCCH

@functools.lru_cache(maxsize=None)
def _f1_static(fc: FullCellConfig, s_total: int):
    """PUCCH F1 low-PAPR sequences per (slot, symbol) + OCC row: one UE per
    PRB with initial_cs 0 and occ 0, so the values are UE-independent."""
    cfg0 = pucch_mod.Pucch01Config(n_id=fc.n_id, slot=0, start_symbol=0,
                                   nof_symbols=14, initial_cs=0)
    ndata = 7
    data_seq = np.empty((s_total, ndata, 12), np.complex64)
    dmrs_seq = np.empty((s_total, ndata, 12), np.complex64)
    for sl in range(s_total):
        c = dataclasses.replace(cfg0, slot=sl)
        for m in range(ndata):
            data_seq[sl, m] = pucch_mod._f0_sequence(c, 0, 2 * m + 1)
            dmrs_seq[sl, m] = pucch_mod._f0_sequence(c, 0, 2 * m)
    return data_seq, dmrs_seq, pucch_mod._occ(ndata, 0)


@functools.lru_cache(maxsize=None)
def _f1_tensors(fc: FullCellConfig, s_total: int, device: torch.device):
    return _dev(*_f1_static(fc, s_total), device=device)


def _f1_symbols(ack: torch.Tensor, fc: FullCellConfig,
                s_total: int) -> torch.Tensor:
    """(S, U, 2) ACK bits -> (S, 14, 12U) PUCCH F1 REs (QPSK data on odd
    symbols, DM-RS on even; UE u on PRB u)."""
    data_seq, dmrs_seq, w = _f1_tensors(fc, s_total, ack.device)
    s, u, _ = ack.shape
    b = ack.to(torch.float32)
    d = torch.complex(1.0 - 2.0 * b[..., 0], 1.0 - 2.0 * b[..., 1]) / SQRT2
    data = d[:, :, None, None] * w[None, None, :, None] * data_seq[:, None]
    dmrs = (w[None, None, :, None] * dmrs_seq[:, None]).expand(data.shape)
    rows = torch.stack([dmrs, data], dim=3)                 # (S, U, 7, 2, 12)
    return rows.reshape(s, u, 14, 12).transpose(1, 2).reshape(s, 14, u * 12)


def _f1_detect(rx_grid: torch.Tensor, fc: FullCellConfig, s_total: int):
    """(S, nsymb, nsubc) grid -> ((S, U, 2) ACK bits, (S, U) |metric|): the
    DM-RS despread estimates each occasion's channel, the data despread is
    derotated by it."""
    data_seq, dmrs_seq, w = _f1_tensors(fc, s_total, rx_grid.device)
    u, s = fc.nof_ue, rx_grid.shape[0]
    rx = rx_grid[:, :14, :u * 12].reshape(s, 7, 2, u, 12)
    rx_dmrs = rx[:, :, 0].transpose(1, 2)                   # (S, U, 7, 12)
    rx_data = rx[:, :, 1].transpose(1, 2)
    wc = w.conj()
    h = torch.einsum("sumn,smn,m->su", rx_dmrs, dmrs_seq.conj(), wc) / (7 * 12)
    z = torch.einsum("sumn,smn,m->su", rx_data, data_seq.conj(), wc) / (7 * 12)
    d = z * h.conj()
    bits = torch.stack([d.real < 0, d.imag < 0], dim=-1).to(torch.int8)
    return bits, z.abs()


@functools.lru_cache(maxsize=None)
def _f2_static(fc: FullCellConfig, s_total: int):
    """PUCCH F2 static mapping: absolute data / DM-RS subcarriers per UE,
    per-(occasion, UE, symbol) DM-RS values, per-UE scrambling inits."""
    slots = fc.csi_slots(s_total)
    u_cnt = fc.nof_ue
    data_sc = np.stack([pucch_mod._f2_data_sc(1) + 12 * (fc.prach_freq_prb + u)
                        for u in range(u_cnt)])             # (U, 8)
    dmrs_sc = np.stack([pucch_mod._f2_dmrs_sc(1) + 12 * (fc.prach_freq_prb + u)
                        for u in range(u_cnt)])             # (U, 4)
    pil = np.empty((len(slots), u_cnt, 2, 4), np.complex64)
    for i, sl in enumerate(slots):
        for u in range(u_cnt):
            cfg = fc.pucch_f2_cfg(u, int(sl))
            for l in range(2):
                c = sequences.np_gold_sequence(pucch_mod._f2_dmrs_cinit(cfg, l),
                                               2 * (4 + 4 * cfg.start_prb))
                c = c[8 * cfg.start_prb:]
                pil[i, u, l] = (((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2]))
                                / SQRT2)[:4]
    ci = np.asarray([(0x4601 + u) << 15 | fc.n_id for u in range(u_cnt)],
                    np.int64)
    nearest = np.abs(pucch_mod._f2_data_sc(1)[:, None]
                     - pucch_mod._f2_dmrs_sc(1)[None, :]).argmin(axis=1)
    return slots, data_sc, dmrs_sc, pil, ci, nearest


@functools.lru_cache(maxsize=None)
def _f2_tensors(fc: FullCellConfig, s_total: int, device: torch.device):
    slots, data_sc, dmrs_sc, pil, ci, nearest = _f2_static(fc, s_total)
    return _dev(data_sc.reshape(-1), dmrs_sc.reshape(-1), pil,
                np.tile(ci, len(slots)), nearest, device=device)


def _f2_symbols(csi: torch.Tensor, fc: FullCellConfig,
                s_total: int) -> torch.Tensor:
    """(S_csi, U, K) UCI bits -> (S_csi, 2, nsubc) F2 symbol rows."""
    data_sc, dmrs_sc, pil, ci, _ = _f2_tensors(fc, s_total, csi.device)
    n, u, k = csi.shape
    e = 2 * 8 * 2   # QPSK * 8 data subcarriers * 2 symbols (1 PRB)
    coded = short_block.encode(csi.reshape(n * u, k), e)
    syms = modulation.modulate(sequences.scramble_bits(coded, ci), "qpsk")
    syms = syms.reshape(n, u, 2, 8).transpose(1, 2).reshape(n, 2, u * 8)
    rows = torch.zeros((n, 2, fc.timing.nof_subc), dtype=torch.complex64,
                       device=csi.device)
    rows[:, :, data_sc] = syms
    rows[:, :, dmrs_sc] = pil.transpose(1, 2).reshape(n, 2, u * 4)
    return rows


def _f2_decode(rx_grid_csi: torch.Tensor, fc: FullCellConfig, s_total: int):
    """(S_csi, nsymb, nsubc) grids of the CSI slots -> ((S_csi, U, K) bits,
    (S_csi, U) valid): DM-RS estimate, MMSE, demap, descramble, RM detect."""
    data_sc, dmrs_sc, pil, ci, nearest = _f2_tensors(fc, s_total,
                                                     rx_grid_csi.device)
    n, u = rx_grid_csi.shape[0], fc.nof_ue
    rx_d = rx_grid_csi[:, :2, dmrs_sc].reshape(n, 2, u, 4).transpose(1, 2)
    h_syms = rx_d * pil.conj()                              # (N, U, 2, 4)
    h_p = h_syms.mean(dim=2)                                # (N, U, 4)
    resid = h_syms - h_p[:, :, None]
    nv = (resid.abs() ** 2).mean(dim=(2, 3)) * 2.0          # (N, U)
    h_data = h_p[:, :, nearest]                             # (N, U, 8)
    y = rx_grid_csi[:, :2, data_sc].reshape(n, 2, u, 8).transpose(1, 2)
    hh = h_data[:, :, None].expand(y.shape)
    nvb = nv[:, :, None, None].expand(y.shape)
    xh = y * hh.conj() / (hh.abs() ** 2 + nvb)
    nv_out = nvb / torch.clamp(hh.abs() ** 2, min=1e-12)
    llr = modulation.demodulate_soft(xh.reshape(n * u, -1),
                                     nv_out.reshape(n * u, -1), "qpsk",
                                     quantize=False)
    llr = sequences.scramble_llrs(llr, ci)
    bits, metric = short_block.detect(llr, fc.csi_bits)
    return bits.reshape(n, u, -1), (metric > 0).reshape(n, u)


# ================================================================= SRS

@functools.lru_cache(maxsize=None)
def _srs_static(fc: FullCellConfig):
    seqs = np.stack([csi_rs.srs_sequence(fc.srs_cfg(u))
                     for u in range(fc.nof_ue)])            # (U, m_sc)
    scs = np.stack([csi_rs.srs_subcarriers(fc.srs_cfg(u))
                    for u in range(fc.nof_ue)])             # (U, m_sc)
    row = np.zeros((fc.timing.nof_subc,), np.complex64)
    row[scs.reshape(-1)] = seqs.reshape(-1)
    return seqs, scs, row


@functools.lru_cache(maxsize=None)
def _srs_tensors(fc: FullCellConfig, device: torch.device):
    seqs, scs, row = _srs_static(fc)
    return _dev(seqs, scs.astype(np.int64), row, device=device)


def _srs_estimate(rx_grid_srs: torch.Tensor, fc: FullCellConfig):
    """(S_srs, nsymb, nsubc) -> ((S_srs, U, m_sc) H, (S_srs, U) SNR dB): LS
    snapshot on each UE's comb, noise from adjacent-estimate differences."""
    seqs, scs, _ = _srs_tensors(fc, rx_grid_srs.device)
    h = rx_grid_srs[:, 13, scs] * seqs.conj()               # (S_srs, U, m_sc)
    d = h[..., 1::2] - h[..., 0::2]
    noise = (d.abs() ** 2).mean(dim=-1) / 2.0
    sig = (h.abs() ** 2).mean(dim=-1)
    snr = 10.0 * torch.log10(torch.clamp(sig, min=1e-30)
                             / torch.clamp(noise, min=1e-30))
    return h, snr


# ================================================================ PRACH

@functools.lru_cache(maxsize=None)
def _prach_static(fc: FullCellConfig):
    """Root-sequence DFTs of the cell's roots and each preamble's (root row,
    N_cs zone start); the zone width."""
    cfg = fc.prach_cfg()
    l_ra = cfg.l_ra
    table = cfg.preamble_table
    offsets = sorted({off for off, _, _ in table})
    row_of = {off: i for i, off in enumerate(offsets)}
    roots = np.stack([prach_mod.root_sequence(
        prach_mod.sequence_number(cfg.root_sequence_index + off, l_ra), l_ra)
        for off in offsets])
    root_f = np.fft.fft(roots, axis=-1).astype(np.complex64)
    win = min(cfg.n_cs if cfg.n_cs else l_ra, l_ra)
    rows = np.asarray([row_of[off] for off, _, _ in table])
    starts = np.asarray([(l_ra - cv) % l_ra for _, _, cv in table])
    return root_f, rows, starts, win


@functools.lru_cache(maxsize=None)
def _prach_tensors(fc: FullCellConfig, device: torch.device):
    root_f, rows, starts, win = _prach_static(fc)
    zone = starts[:, None] + np.arange(win)[None, :]        # (64, win)
    return _dev(root_f.conj(), rows[:, None], zone, device=device)


def _prach_detect_batch(rx_freq: torch.Tensor, fc: FullCellConfig):
    """(B, L_RA) frequency-domain occasions -> ((B, 64) metric, delay,
    detected): per-root correlation by IDFT, each preamble's max over its own
    N_cs zone against the occasion's mean power."""
    root_conj, rows, zone = _prach_tensors(fc, rx_freq.device)
    corr_t = torch.fft.ifft(rx_freq[:, None, :] * root_conj, dim=-1)
    power = corr_t.abs() ** 2                               # (B, R, L)
    floor = power.mean(dim=(1, 2), keepdim=True)[:, :, 0] + 1e-30
    power2 = torch.cat([power, power], dim=-1)              # wrap-around
    zones = power2[:, rows, zone]                           # (B, 64, win)
    peak, delays = zones.max(dim=-1)
    metrics = peak / floor
    return metrics, delays, metrics > fc.prach_threshold


def prach_occasion_td(fc: FullCellConfig, preamble_index: int,
                      delay: int = 24, amplitude: float = 1.0) -> np.ndarray:
    """Static time-domain PRACH occasion, padded to one slot and delayed:
    the UE-side transmit, with a raised-cosine edge taper over half the CP
    on each side (a rectangular window leaks across the 15 kHz grid)."""
    cfg = fc.prach_cfg()
    info = fc.prach_info()
    u_root, cv = cfg.preamble(preamble_index)
    pre = np.fft.fft(np.roll(prach_mod.root_sequence(u_root, cfg.l_ra), -cv))
    x = np.zeros(info.dft_size, np.complex128)
    x[(info.freq_offset_bins + np.arange(cfg.l_ra)) % info.dft_size] = pre
    body = np.fft.ifft(x) * np.sqrt(info.dft_size)
    td = np.concatenate([body[info.dft_size - info.cp_samples:], body])
    ramp = info.cp_samples // 2
    w = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
    td[:ramp] *= w
    td[-ramp:] *= w[::-1]
    td = (td / np.sqrt(np.mean(np.abs(td) ** 2)) * amplitude).astype(np.complex64)
    total = fc.timing.cp.total
    out = np.zeros(total, np.complex64)
    n = min(len(td), total - delay)
    out[delay:delay + n] = td[:n]
    return out


# ============================================================ UE UL TX

def _ue_ul_control(ack: torch.Tensor, csi: torch.Tensor, fc: FullCellConfig,
                   s_total: int) -> torch.Tensor:
    """(S, nsymb, nsubc) UE control contribution: PUCCH F1 every slot, F2
    CSI and SRS on their occasions."""
    dev = ack.device
    t = fc.timing
    u = fc.nof_ue
    extra = torch.zeros((s_total, t.nsymb, t.nof_subc), dtype=torch.complex64,
                        device=dev)
    extra[:, :14, :u * 12] = _f1_symbols(ack, fc, s_total)
    extra[_slot_slice(fc.csi_slots(s_total)), 0:2] += \
        _f2_symbols(csi, fc, s_total)
    extra[_slot_slice(fc.srs_slots(s_total)), 13] += _srs_tensors(fc, dev)[2]
    return extra


def ue_ul_slot_batch(payloads, ack, csi, fc: FullCellConfig, s_total: int,
                     prach_preamble: int = 7, prach_delay: int = 24,
                     prach_amplitude: float = 0.002,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """UE-side UL generator: (S, U, TBS_ul) PUSCH payloads + (S, U, 2) ACK
    bits + (S_csi, U, K) CSI bits -> (S, total) clean UL samples with
    PUSCH + PUCCH F1 (+ F2 / SRS / PRACH on their occasions).  The PRACH
    preamble arrives ``prach_amplitude`` under the PUSCH RMS (open-loop
    power control targets the detector, not the PUSCH level)."""
    cell = fc.ul_cell()
    sp._check_siso(cell)
    dev = resolve_device(device)
    payloads, ack, csi = (torch.as_tensor(x, device=dev)
                          for x in (payloads, ack, csi))
    t = cell.timing
    s, u, tbs = payloads.shape
    syms = sp._dl_code(payloads.reshape(s * u, tbs), _rntis(fc, dev),
                       cell).reshape(s, u, -1)
    grid = sp._dl_grid(syms, cell)                # PUSCH DM-RS boost sqrt(2)
    td = ofdm.modulate_slot(grid + _ue_ul_control(ack, csi, fc, s_total), t,
                            scale=1.0 / t.nfft)
    ptd = torch.as_tensor(prach_occasion_td(fc, prach_preamble, prach_delay,
                                            prach_amplitude), device=dev)
    td[_slot_slice(fc.prach_slots(s_total))] += ptd
    return td


def ue_ul_slot_batch_mimo(payloads, ack, csi, fc: FullCellConfig, s_total: int,
                          prach_preamble: int = 7, prach_delay: int = 24,
                          prach_amplitude: float = 0.002,
                          device: str | torch.device = "cuda") -> torch.Tensor:
    """UE-side MIMO UL generator: (S, U, TBS_L) PUSCH payloads (+ ACK / CSI)
    -> (S, L, total) per-port samples.  PUSCH layers on all ports; PUCCH
    F1/F2, SRS and the PRACH occasion on port 0."""
    dev = resolve_device(device)
    payloads, ack, csi = (torch.as_tensor(x, device=dev)
                          for x in (payloads, ack, csi))
    td = sp.dl_slot_batch_mimo(payloads, _rntis(fc, dev), fc.ul_cell(),
                               extra_rows=_ue_ul_control(ack, csi, fc, s_total),
                               device=dev)                     # (S, L, total)
    ptd = torch.as_tensor(prach_occasion_td(fc, prach_preamble, prach_delay,
                                            prach_amplitude), device=dev)
    td[_slot_slice(fc.prach_slots(s_total)), 0] += ptd
    return td


# ============================================================ gNB UL RX

def _ul_results(payload, tb_ok, nv, cfo, soft, rx_grid0, rx0,
                fc: FullCellConfig, s_total: int, soft_flat: bool) -> dict:
    """The UL result dict: the PUSCH outputs, and the single-port control
    channels detected on one antenna's grid ``rx_grid0`` (S, nsymb, nsubc)
    and samples ``rx0`` (S, total)."""
    s, u = rx_grid0.shape[0], fc.nof_ue
    seg, _ = sp._plans(fc.ul_cell(), 0)
    ack_bits, ack_metric = _f1_detect(rx_grid0, fc, s_total)
    csi_bits, csi_ok = _f2_decode(_slot_take(rx_grid0, fc.csi_slots(s_total)),
                                  fc, s_total)
    srs_h, srs_snr = _srs_estimate(_slot_take(rx_grid0, fc.srs_slots(s_total)),
                                   fc)
    info = fc.prach_info()
    win = _slot_take(rx0, fc.prach_slots(s_total))[
        :, :info.cp_samples + info.dft_size]
    rx_freq = prach_mod.ofdm_demodulate_prach(win, info)
    pr_metric, pr_delay, pr_det = _prach_detect_batch(rx_freq, fc)
    return {
        "payload": payload.reshape(s, u, -1),
        "tb_ok": tb_ok.reshape(s, u),
        "noise_var": nv, "cfo": cfo,
        "soft": soft if soft_flat else soft.reshape(s, u * seg.c, -1),
        "ack_bits": ack_bits, "ack_metric": ack_metric,
        "csi_bits": csi_bits, "csi_ok": csi_ok,
        "srs_h": srs_h, "srs_snr_db": srs_snr,
        "prach_metric": pr_metric, "prach_delay": pr_delay,
        "prach_detected": pr_det,
    }


def gnb_ul_slot_batch(rx, fc: FullCellConfig, s_total: int,
                      soft_in=None, new_data=None,
                      num_iters: int = decoder.DEFAULT_ITERS,
                      soft_flat: bool = False, early_stop: bool = True,
                      device: str | torch.device = "cuda") -> dict:
    """Full UL slot batch: (S, total) samples -> every UL channel's results.

    Returns a dict: payload (S, U, TBS), tb_ok (S, U), noise_var, cfo,
    soft (S, U*C, n_cb) HARQ state, ack_bits (S, U, 2), ack_metric (S, U),
    csi_bits (S_csi, U, K), csi_ok (S_csi, U), srs_h (S_srs, U, m_sc),
    srs_snr_db (S_srs, U), prach_metric / delay / detected (S_prach, 64).

    ``soft_flat``: take and return the HARQ state in the decoder's flat
    (S*U*C, n_cb) layout, as a caller does that feeds it straight back.
    ``new_data``: (S, U) mask, 1 = new transmission (its buffer is zeroed).
    """
    cell = fc.ul_cell()
    sp._check_siso(cell)
    dev = resolve_device(device)
    rx = torch.as_tensor(rx, device=dev)
    s, u = rx.shape[0], fc.nof_ue
    rx_grid = ofdm.demodulate_slot(rx, cell.timing, scale=1.0)  # (S, nsymb, nsubc)
    llr, nv, cfo = sp._ul_front(None, _rntis(fc, dev), cell, rx_grid=rx_grid)
    sb_flat, nd_flat = sp._harq_flat(soft_in, new_data, cell, s, dev, soft_flat)
    payload, tb_ok, soft = sp._ul_back(llr.reshape(s * u, -1), cell, 0,
                                       num_iters, sb_flat, nd_flat,
                                       early_stop=early_stop)
    return _ul_results(payload, tb_ok, nv, cfo, soft, rx_grid, rx, fc, s_total,
                       soft_flat)


# ============================================================ MIMO variants

def _dl_control_rows(dci: torch.Tensor, fc: FullCellConfig,
                     s_total: int) -> torch.Tensor:
    """(S, nsymb, nsubc) port-0 control contribution: PDCCH on symbol 0
    every slot, NZP-CSI-RS on its occasions (the SSB blocks are added onto
    the SSB sub-batch by the caller)."""
    t = fc.timing
    extra = torch.zeros((s_total, t.nsymb, t.nof_subc), dtype=torch.complex64,
                        device=dci.device)
    extra[:, 0] += pdcch_rows(dci, fc, s_total)
    extra[:, fc.csi_rs_symbol] += _csi_rs_rows(fc, s_total, dci.device)
    return extra


def gnb_dl_slot_batch_mimo(pay_norm, pay_ssb, dci, pbch, fc: FullCellConfig,
                           s_total: int, device: str | torch.device = "cuda"
                           ) -> torch.Tensor:
    """Full MIMO DL slot batch -> (S, L, total) per-port samples; payloads
    at the L-layer TBS of ``dl_cell_mimo`` / ``dl_cell_ssb_mimo``.  The
    sub-batches' grids are merged and modulated once."""
    dev = resolve_device(device)
    pay_norm, pay_ssb, dci, pbch = (torch.as_tensor(x, device=dev)
                                    for x in (pay_norm, pay_ssb, dci, pbch))
    cell_n, cell_s = fc.dl_cell_mimo(), fc.dl_cell_ssb_mimo()
    if fc.ssb_slots(s_total)[0] != 0:
        raise ValueError("the SSB occasions must start at slot 0")
    k = fc.ssb_period
    rntis = _rntis(fc, dev)
    extra = _dl_control_rows(dci, fc, s_total)
    sc0 = fc.ssb_first_subcarrier
    ex_s = extra[0::k].clone()
    ex_s[:, 2:6, sc0:sc0 + 240] += ssb_blocks(pbch, fc, s_total)
    g_n = sp.dl_slot_batch_mimo(pay_norm, rntis, cell_n,
                                extra_rows=_slot_drop_period(extra, k),
                                return_grid=True, device=dev)
    g_s = sp.dl_slot_batch_mimo(pay_ssb, rntis, cell_s, extra_rows=ex_s,
                                return_grid=True, device=dev)
    grid = _slot_merge_period(g_s, g_n, k, s_total)
    t = fc.timing
    td = ofdm.modulate_slot(grid, t, scale=1.0 / t.nfft)
    if fc.tx_ceiling > 0:
        td, _ = amplitude.clip(td, fc.tx_gain, fc.tx_ceiling)
    else:
        td, _ = amplitude.scale(td, fc.tx_gain)
    return td


def gnb_ul_slot_batch_mimo(rx, fc: FullCellConfig, s_total: int,
                           soft_in=None, new_data=None,
                           num_iters: int = decoder.DEFAULT_ITERS,
                           soft_flat: bool = False, early_stop: bool = True,
                           device: str | torch.device = "cuda") -> dict:
    """Full MIMO UL slot batch: (S, P, total) antenna samples -> the result
    dict of ``gnb_ul_slot_batch`` (payload at the L-layer TBS).  All
    antennas are demodulated once; PUSCH takes the LxP front, PUCCH F1/F2,
    SRS and PRACH antenna 0."""
    cell = fc.ul_cell()
    dev = resolve_device(device)
    rx = torch.as_tensor(rx, device=dev)
    t = cell.timing
    s, p_rx = rx.shape[:2]
    rx_grid = ofdm.demodulate_slot(rx.reshape(s * p_rx, -1), t, scale=1.0)
    rx_grid = rx_grid.reshape(s, p_rx, t.nsymb, t.nof_subc)
    llr, nv, cfo = sp._ul_front_mimo(None, _rntis(fc, dev), cell,
                                     rx_grid=rx_grid)
    sb_flat, nd_flat = sp._harq_flat(soft_in, new_data, cell, s, dev, soft_flat)
    payload, tb_ok, soft = sp._ul_back(llr, cell, 0, num_iters, sb_flat,
                                       nd_flat, early_stop=early_stop)
    return _ul_results(payload, tb_ok, nv, cfo, soft, rx_grid[:, 0], rx[:, 0],
                       fc, s_total, soft_flat)
