"""Cell slot pipeline, data plane: multi-UE DL encode + UL decode.

Port of ``srsran_edgeric_5g_tpu/parallel/slot_pipeline.py`` (the SISO,
multi-cell and multi-layer programs).  One call processes a batch of slots
for all UEs of a cell, or of several same-config carriers.  UE allocations
are uniform-width and contiguous from a static first PRB, so every per-UE
gather/scatter is a slice + reshape.  The reference's mesh sharding has no
counterpart here: on one card the UE and codeblock axes are plain batch
dimensions.

DL: segment -> LDPC encode -> rate match -> scramble -> modulate -> place
subgrids -> OFDM modulate.  UL: OFDM demod -> DM-RS estimate -> MMSE
equalize -> demap -> wire quantise -> descramble -> rate dematch (+ HARQ
combine into the int8 soft carry) -> LDPC decode (the CUDA kernel on the
card) -> TB CRC.  ``delay_spread_us > 0`` selects the TA + smoothing
channel estimator.

Multi-layer (``n_layers`` = L > 1, ``dl_slot_batch_mimo`` /
``ul_slot_batch_mimo``): one codeword per UE at the L-layer TBS, layer
mapping d(L*i + l) -> layer l, identity precoding, type-1 CDM DM-RS at data
amplitude (ports 0/1 on the even subcarriers with frequency OCC, ports 2/3
on the odd ones), and on the receive side an OCC-despread estimate per
(antenna, port) and the LxP whitened-Gram MMSE.

Multi-cell (``multi_cell_dl_slot_batch`` / ``multi_cell_ul_slot_batch``):
NC independent carriers of one configuration flatten into the slot batch,
rows cell-major, then slot, then UE, each carrier with its own RNTIs; one
decode covers every codeblock of every carrier.

The entry points (``dl_slot``, ``dl_slot_batch``, ``ul_slot``,
``ul_slot_batch``, the multi-cell pair and the ``*_mimo`` pair) take
``device`` ("cuda" by default) and move their inputs there; a CUDA request
on a host without a CUDA device raises.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import resolve_device
from ..ops import channel_est, equalizer, modulation, ofdm, sequences
from ..ops import dmrs as dmrs_mod
from ..ops.ldpc import decoder, encoder, rate_match, segmenter
from ..ran.numerology import N_SC_PER_PRB, SlotTiming, slot_timing
from ..ran.tbs import nof_re, tbs as tbs_calc


@dataclasses.dataclass(frozen=True)
class CellConfig:
    """Uniform multi-UE cell configuration for one slot (the same fields as
    the reference's CellConfig, so ``convert.cell_from_dict`` carries one
    across)."""

    nof_prb: int                  # cell bandwidth
    nfft: int
    nof_ue: int
    prb_per_ue: int               # uniform allocation width
    modulation: str = "qam16"
    target_rate: float = 0.5
    first_symbol: int = 2
    nof_symbols: int = 12
    dmrs_symbols: tuple[int, ...] = (2, 11)
    n_id: int = 1
    slot: int = 0
    mu: int = 0
    first_prb: int = 0            # static start of the contiguous UE span
    # 0 = plain LS + linear interpolation; > 0 selects the TA + smoothing
    # estimator (estimate_port_ta) with this delay spread.
    delay_spread_us: float = 0.0
    # Limited-buffer rate matching: 0 = full buffer; > 0 = TBS_LBRM bits.
    tbs_lbrm: int = 0
    # Spatial layers per UE: 1 takes dl_slot_batch / ul_slot_batch, more
    # the *_mimo pair.
    n_layers: int = 1
    # Grid subcarrier of the radio DC position (None = no zeroing).  The UL
    # front zeroes the channel estimate there so that RE's LLRs are erased.
    dc_position: int | None = None

    @property
    def timing(self) -> SlotTiming:
        return slot_timing(nof_prb=self.nof_prb, nfft=self.nfft, mu=self.mu)

    @property
    def data_symbols(self) -> tuple[int, ...]:
        return tuple(s for s in range(self.first_symbol,
                                      self.first_symbol + self.nof_symbols)
                     if s not in self.dmrs_symbols)

    @property
    def qm(self) -> int:
        return modulation.QM[self.modulation]

    @property
    def ue_width_sc(self) -> int:
        return self.prb_per_ue * N_SC_PER_PRB

    @property
    def g_total(self) -> int:
        return len(self.data_symbols) * self.ue_width_sc * self.qm

    def derived_tbs(self) -> int:
        nre = nof_re(self.prb_per_ue, self.nof_symbols,
                     12 * len(self.dmrs_symbols))
        return tbs_calc(nre, self.target_rate, self.qm, self.n_layers)


def _check_siso(cell: CellConfig) -> None:
    """The single-layer programs map one layer; the reference fails on a
    reshape for more."""
    if cell.n_layers != 1:
        raise ValueError(f"n_layers = {cell.n_layers}: the multi-layer data "
                         "plane is dl_slot_batch_mimo / ul_slot_batch_mimo")


@functools.lru_cache(maxsize=None)
def _plans(cell: CellConfig, rv: int = 0):
    tbs = cell.derived_tbs()
    bg = segmenter.select_base_graph(tbs, cell.target_rate)
    seg = segmenter.get_segment_plan(tbs, bg, cell.n_layers * cell.g_total,
                                     cell.qm)
    if len(set(seg.e)) != 1:
        raise ValueError(f"uniform-E configs only in the cell pipeline: {seg.e}")
    n_cb = (rate_match.lbrm_n_cb(seg.bg, seg.zc, seg.c, cell.tbs_lbrm)
            if cell.tbs_lbrm > 0 else None)
    rm = rate_match.get_rate_match_plan(seg.bg, seg.zc, seg.e[0], rv, cell.qm,
                                        seg.k_prime, n_cb=n_cb)
    return seg, rm


@functools.lru_cache(maxsize=None)
def _dmrs_full_band(cell: CellConfig, device: torch.device) -> torch.Tensor:
    """(ndmrs, npilots_fullband) pilot sequences shared by all UEs."""
    rows = []
    for l in cell.dmrs_symbols:
        ci = torch.tensor([dmrs_mod.dmrs_c_init(cell.slot, l, cell.n_id)],
                          dtype=torch.int64, device=device)
        rows.append(dmrs_mod.dmrs_sequence(ci, 6 * cell.nof_prb)[0])
    return torch.stack(rows)


def _scrambling_inits(rntis: torch.Tensor, cell: CellConfig,
                      reps: int) -> torch.Tensor:
    """Per-row c_init (rnti << 15) + n_id for a slot-major (reps*U) batch."""
    return ((rntis.to(torch.int64) << 15) + cell.n_id).repeat(reps)


def _cell_ci(rntis: torch.Tensor, cell: CellConfig, nc: int,
             s: int) -> torch.Tensor:
    """(NC, U) RNTIs -> per-row scrambling inits of the (NC*S*U,) flat
    multi-cell batch (row order cell-major, then slot, then UE)."""
    ci_rows = (rntis.to(torch.int64) << 15) + cell.n_id
    return ci_rows[:, None, :].expand(nc, s, cell.nof_ue).reshape(-1)


def _dl_code(payloads: torch.Tensor, rntis: torch.Tensor | None,
             cell: CellConfig, rv: int = 0,
             ci: torch.Tensor | None = None) -> torch.Tensor:
    """Coding front-end for a flat (B_tb, TBS) batch -> (B_tb, G/Qm) symbols:
    all codeblocks of all TBs go through segment -> encode -> rate match ->
    scramble -> modulate as one batch.  ``ci`` (B_tb,) replaces the per-row
    scrambling inits derived from ``rntis`` (which may then be None)."""
    seg, rm = _plans(cell, rv)
    b_tb = payloads.shape[0]
    cbs = segmenter.segment_tb(payloads, seg)                 # (B_tb*C, K)
    cw = encoder.encode(cbs, seg.bg, seg.zc)                  # (B_tb*C, colsZc)
    bits = rate_match.rate_match(cw, rm).reshape(b_tb, -1)    # (B_tb, G)
    if ci is None:
        ci = _scrambling_inits(rntis, cell, b_tb // cell.nof_ue)
    bits = sequences.scramble_bits(bits, ci)
    return modulation.modulate(bits, cell.modulation)         # (B_tb, G/Qm)


def _dl_grid(syms: torch.Tensor, cell: CellConfig,
             dmrs_scale: float = float(np.sqrt(2.0)),
             add_rows: dict[int, torch.Tensor] | None = None) -> torch.Tensor:
    """(..., U, G/Qm) modulated symbols -> (..., nsymb, nsubc) resource grids.

    ``dmrs_scale``: DM-RS-to-data amplitude; sqrt(2) is the PUSCH
    convention (TS 38.214 3 dB boost for 2 CDM groups without data, which
    the reference receiver assumes), PDSCH passes 1.0.  Type-1 port-0 DM-RS
    on the even subcarriers of the occupied span; all UEs share n_id, so one
    sequence.  ``add_rows``: symbol index -> (..., nsubc) contribution added
    to that symbol's row (control channels on disjoint REs: PDCCH, SSB,
    CSI-RS).
    """
    t = cell.timing
    u, w = cell.nof_ue, cell.ue_width_sc
    span = u * w
    band0 = cell.first_prb * N_SC_PER_PRB
    ndata = len(cell.data_symbols)
    lead = syms.shape[:-2]
    band = syms.reshape(*lead, u, ndata, w).transpose(-3, -2).reshape(
        *lead, ndata, span).to(torch.complex64)
    dev = syms.device
    grid = torch.zeros((*lead, t.nsymb, t.nof_subc), dtype=torch.complex64,
                       device=dev)
    grid[..., list(cell.data_symbols), band0:band0 + span] = band
    p0 = 6 * cell.first_prb
    pil = _dmrs_full_band(cell, dev)[:, p0:p0 + span // 2]
    grid[..., list(cell.dmrs_symbols), band0:band0 + span:2] = (
        pil * float(np.float32(dmrs_scale)))
    for l, row in (add_rows or {}).items():
        grid[..., l, :] += row.to(torch.complex64)
    return grid


def _dl_grid_ofdm(syms: torch.Tensor, cell: CellConfig) -> torch.Tensor:
    """(..., U, G/Qm) modulated symbols -> (..., total) time-domain samples."""
    t = cell.timing
    return ofdm.modulate_slot(_dl_grid(syms, cell), t, scale=1.0 / t.nfft)


def dl_slot(payloads, rntis, cell: CellConfig, rv: int = 0,
            device: str | torch.device = "cuda") -> torch.Tensor:
    """DL direction: (U, TBS) payload bits -> (total,) baseband samples.
    UE u occupies PRBs [first_prb + u*prb_per_ue, ...)."""
    return dl_slot_batch(torch.as_tensor(payloads)[None], rntis, cell, rv,
                         device)[0]


def dl_slot_batch(payloads, rntis, cell: CellConfig, rv: int = 0,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """Slot-batched DL: (S, U, TBS) payload bits + (U,) RNTIs -> (S, total)
    complex64 samples.  The coding front-end runs as ONE flat (S*U) batch;
    grid assembly and OFDM are batched over slots."""
    _check_siso(cell)
    dev = resolve_device(device)
    payloads = torch.as_tensor(payloads, device=dev)
    rntis = torch.as_tensor(rntis, device=dev)
    s, u, tbs = payloads.shape
    syms = _dl_code(payloads.reshape(s * u, tbs), rntis, cell, rv)
    return _dl_grid_ofdm(syms.reshape(s, u, -1), cell)


def ul_slot_batch(rx_samples, rntis, cell: CellConfig, rv: int = 0,
                  num_iters: int = decoder.DEFAULT_ITERS,
                  soft_buffer=None, new_data=None,
                  device: str | torch.device = "cuda"):
    """Slot-batched UL: (S, total) samples -> (payload (S, U, TBS) int8,
    tb_ok (S, U), noise_var (S, U), cfo (S, U), soft (S, U*C, n_cb) int8).

    ``soft`` is the HARQ circular buffer per codeblock; feed it back as
    ``soft_buffer`` with the retransmission's ``rv`` for chase/IR
    combining.  ``new_data``: (S, U) float mask, 1 = first transmission of
    that TB (its soft buffer is zeroed before combining).  The front-end
    and the dematch/decode back-end run as one flat (S*U) TB batch.
    """
    _check_siso(cell)
    dev = resolve_device(device)
    rx_samples = torch.as_tensor(rx_samples, device=dev)
    rntis = torch.as_tensor(rntis, device=dev)
    s, u = rx_samples.shape[0], cell.nof_ue
    seg, _ = _plans(cell, rv)
    llr, nv, cfo = _ul_front(rx_samples, rntis, cell)         # (S, U, G)
    sb_flat, nd_flat = _harq_flat(soft_buffer, new_data, cell, s, dev)
    payload, tb_ok, soft = _ul_back(llr.reshape(s * u, -1), cell, rv,
                                    num_iters, sb_flat, nd_flat)
    return (payload.reshape(s, u, -1), tb_ok.reshape(s, u), nv, cfo,
            soft.reshape(s, u * seg.c, -1))


def _harq_flat(soft_buffer, new_data, cell: CellConfig, s: int,
               dev: torch.device, soft_flat: bool = False):
    """The HARQ carry in the decoder's flat (S*U*C, n_cb) layout (given in
    that layout with ``soft_flat``, else as (S, U*C, n_cb)) and the flat
    (S*U,) new_data mask, on ``dev``; each None when not given."""
    sb_flat = None if soft_buffer is None else torch.as_tensor(soft_buffer, device=dev)
    if sb_flat is not None and not soft_flat:
        sb_flat = sb_flat.reshape(s * cell.nof_ue * _plans(cell)[0].c, -1)
    nd_flat = (None if new_data is None else
               torch.as_tensor(new_data, device=dev).reshape(s * cell.nof_ue))
    return sb_flat, nd_flat


def ul_slot(rx_samples, rntis, cell: CellConfig, rv: int = 0,
            num_iters: int = decoder.DEFAULT_ITERS, soft_buffer=None,
            device: str | torch.device = "cuda"):
    """UL direction: (total,) samples -> decoded (U, TBS), (U,) crc_ok,
    (U,) noise_var, (U,) cfo, (U*C, n_cb) HARQ soft buffer."""
    sb = None if soft_buffer is None else torch.as_tensor(soft_buffer)[None]
    payload, tb_ok, nv, cfo, soft = ul_slot_batch(
        torch.as_tensor(rx_samples)[None], rntis, cell, rv, num_iters, sb,
        device=device)
    return payload[0], tb_ok[0], nv[0], cfo[0], soft[0]


def _ul_front(rx_samples: torch.Tensor | None, rntis: torch.Tensor | None,
              cell: CellConfig, rx_grid: torch.Tensor | None = None,
              ci: torch.Tensor | None = None):
    """OFDM demod -> chest -> MMSE -> demap -> wire quantise -> descramble:
    (S, total) samples -> ((S, U, G) LLRs, (S, U) noise_var, (S, U) cfo).
    ``rx_grid`` (S, nsymb, nsubc) skips the OFDM demodulation when the
    caller already demodulated the slots (the full cell shares one grid
    between PUSCH, PUCCH and SRS).  ``ci`` (S*U,) replaces the per-row
    descrambling inits derived from ``rntis`` (multi-cell flattens the
    carriers into the S dim)."""
    t = cell.timing
    u, w = cell.nof_ue, cell.ue_width_sc
    span = u * w
    band0 = cell.first_prb * N_SC_PER_PRB

    if rx_grid is None:
        rx_grid = ofdm.demodulate_slot(rx_samples, t, scale=1.0)
    s = rx_grid.shape[0]
    dev = rx_grid.device
    band = rx_grid[..., band0:band0 + span]                   # (S, nsymb, span)

    pilots = _dmrs_full_band(cell, dev)
    pat = dmrs_mod.dmrs_pattern(1, cell.prb_per_ue, port=0)
    span_pat = dmrs_mod.dmrs_pattern(1, u * cell.prb_per_ue, port=0)
    times = np.asarray([t.cp.data_starts[l] for l in cell.dmrs_symbols]) / t.srate
    npil_ue = len(pat.subcarriers)
    ndmrs = len(cell.dmrs_symbols)
    ndata = len(cell.data_symbols)
    if not (span_pat.subcarriers == np.arange(0, u * w, 2)).all():
        raise ValueError("pipeline assumes type-1 port-0 DM-RS (even subcarriers)")

    rx_p = band[:, list(cell.dmrs_symbols), 0::2]             # (S, ndmrs, span/2)
    rx_p = rx_p.reshape(s, ndmrs, u, npil_ue).permute(0, 2, 1, 3)
    rx_p = rx_p.reshape(s * u, ndmrs, npil_ue)
    # Undo the TS 38.214 3 dB DM-RS boost on the RX pilots: the LS
    # estimate's conj-product convention needs unit-amplitude references.
    rx_p = rx_p * float(np.float32(1.0 / np.sqrt(2.0)))
    p0 = 6 * cell.first_prb
    ref_p = pilots[:, p0:p0 + len(span_pat.subcarriers)]
    ref_p = ref_p.reshape(ndmrs, u, npil_ue).permute(1, 0, 2).repeat(s, 1, 1)
    y = band[:, list(cell.data_symbols)]
    y = y.reshape(s, ndata, u, w).permute(0, 2, 1, 3).reshape(s * u, ndata, w)

    times_opt = times if ndmrs > 1 else None
    if cell.delay_spread_us > 0:
        h, nv, cfo, _ = channel_est.estimate_port_ta(
            rx_p, ref_p, pat.subcarriers, w, 15e3 * (1 << cell.mu),
            dmrs_symbol_times_s=times_opt,
            delay_spread_s=cell.delay_spread_us * 1e-6)
    else:
        h, nv, cfo = channel_est.estimate_port(rx_p, ref_p, pat.subcarriers, w,
                                               dmrs_symbol_times_s=times_opt)
    # DC-position zeroing: rows are slot-major (index = slot*U + ue); a zero
    # estimate makes the equalizer erase that RE (abnormal-input rule).
    if cell.dc_position is not None and band0 <= cell.dc_position < band0 + span:
        ue_dc, off_dc = divmod(cell.dc_position - band0, w)
        h = h.clone()
        h[ue_dc::u, off_dc] = 0
    # The estimator derotated the pilots by their symbol times, so each data
    # symbol still carries e^{j2pi*cfo*t_l}: remove it (float32 phase, as
    # the reference).
    if ndmrs > 1:
        t_data = torch.as_tensor(
            np.asarray([t.cp.data_starts[l] for l in cell.data_symbols],
                       np.float32) / np.float32(t.srate), device=dev)
        ph = float(np.float32(-2.0 * np.pi)) * cfo[:, None] * t_data
        y = y * torch.complex(torch.cos(ph), torch.sin(ph))[:, :, None]

    hh = h[:, None, :].expand(y.shape)
    x_hat, nv_out = equalizer.equalize_mmse_1xn(y[None], hh[None],
                                                nv[None, :, None, None])
    llr = modulation.demodulate_soft(x_hat.reshape(s * u, -1),
                                     nv_out.reshape(s * u, -1),
                                     cell.modulation, quantize=False)
    # The reference's int8 wire domain (in float): pairs with the decoder's
    # 'wire_auto' schedule.
    llr = modulation.wire_quantize(llr, cell.modulation)
    if ci is None:
        ci = _scrambling_inits(rntis, cell, s)
    llr = sequences.scramble_llrs(llr, ci)
    return llr.reshape(s, u, -1), nv.reshape(s, u), cfo.reshape(s, u)


def _decoder_input(llr: torch.Tensor, cell: CellConfig, rv: int = 0,
                   soft_buffer: torch.Tensor | None = None,
                   new_data: torch.Tensor | None = None) -> torch.Tensor:
    """Rate dematch (+ HARQ combine) of a flat (B_tb, G) wire-LLR batch ->
    (B_tb*C, cols*Zc) int8 decoder input.

    Wire-domain combine: every LLR is an integer (demap clip ±20 -> ±120)
    and the combined buffer saturates at ±127 — the reference's saturated
    LLR sum — so the dematch runs in bf16 (integers <= 247 are exact) and
    the result is exactly int8.  A new transmission (``new_data`` 1) zeroes
    its soft buffer before combining."""
    seg, rm = _plans(cell, rv)
    b_tb = llr.shape[0]
    cb_llr = llr.reshape(b_tb * seg.c, rm.e)
    if soft_buffer is not None and new_data is not None:
        keep = (1.0 - new_data).to(soft_buffer.dtype)
        soft_buffer = soft_buffer * keep.repeat_interleave(seg.c)[:, None]
    full = rate_match.rate_dematch(cb_llr, rm, soft_buffer,
                                   dtype=torch.bfloat16, saturate=True)
    return full.to(torch.int8)


def _ul_back(llr: torch.Tensor, cell: CellConfig, rv: int = 0,
             num_iters: int = decoder.DEFAULT_ITERS,
             soft_buffer: torch.Tensor | None = None,
             new_data: torch.Tensor | None = None,
             early_stop: bool = True):
    """Rate dematch (+ HARQ soft combine) + LDPC decode + TB CRC for a flat
    (B_tb, G) LLR batch -> (payload, tb_ok, new_soft), new_soft the
    (B_tb*C, n_cb) int8 circular buffers (the per-HARQ-process rx_buffer
    state of the reference)."""
    seg, rm = _plans(cell, rv)
    full = _decoder_input(llr, cell, rv, soft_buffer, new_data)
    new_soft = full[:, 2 * seg.zc:2 * seg.zc + rm.n_cb]
    hard, _ = decoder.decode(full, seg.bg, seg.zc, num_iters=num_iters,
                             early_stop=early_stop, schedule="wire_auto")
    payload, tb_ok = segmenter.desegment_tb(hard, seg)
    return payload, tb_ok, new_soft


# ================================================================= multi-cell

def multi_cell_dl_slot_batch(payloads, rntis, cell: CellConfig, rv: int = 0,
                             device: str | torch.device = "cuda") -> torch.Tensor:
    """Multi-carrier DL: (NC, S, U, TBS) payloads + (NC, U) RNTIs ->
    (NC, S, total) complex64 samples.

    The carriers are independent cells of one configuration (the reference
    runs one PHY instance per sector), so they flatten into the slot batch:
    the coding front-end runs as one (NC*S*U) TB batch, grid + OFDM over
    NC*S slots."""
    _check_siso(cell)
    dev = resolve_device(device)
    payloads = torch.as_tensor(payloads, device=dev)
    rntis = torch.as_tensor(rntis, device=dev)
    nc, s, u, tbs = payloads.shape
    syms = _dl_code(payloads.reshape(nc * s * u, tbs), None, cell, rv,
                    ci=_cell_ci(rntis, cell, nc, s))
    return _dl_grid_ofdm(syms.reshape(nc * s, u, -1), cell).reshape(nc, s, -1)


def multi_cell_ul_slot_batch(rx_samples, rntis, cell: CellConfig, rv: int = 0,
                             num_iters: int = decoder.DEFAULT_ITERS,
                             device: str | torch.device = "cuda"):
    """Multi-carrier UL: (NC, S, total) samples + (NC, U) RNTIs ->
    (payload (NC, S, U, TBS), tb_ok, noise_var, cfo (NC, S, U),
    soft (NC, S, U*C, n_cb)).  The carriers flatten into the slot batch:
    one front-end over NC*S slots and one early-stop decode over all
    NC*S*U*C codeblocks."""
    _check_siso(cell)
    dev = resolve_device(device)
    rx_samples = torch.as_tensor(rx_samples, device=dev)
    rntis = torch.as_tensor(rntis, device=dev)
    nc, s, total = rx_samples.shape
    u = cell.nof_ue
    seg, _ = _plans(cell, rv)
    llr, nv, cfo = _ul_front(rx_samples.reshape(nc * s, total), None, cell,
                             ci=_cell_ci(rntis, cell, nc, s))
    payload, tb_ok, soft = _ul_back(llr.reshape(nc * s * u, -1), cell, rv,
                                    num_iters)
    return (payload.reshape(nc, s, u, -1), tb_ok.reshape(nc, s, u),
            nv.reshape(nc, s, u), cfo.reshape(nc, s, u),
            soft.reshape(nc, s, u * seg.c, -1))


# ================================================================ multi-layer

def _span_dmrs(cell: CellConfig, port: int):
    """Static span-wide DM-RS geometry of one port: (span subcarrier offsets,
    frequency OCC per pilot, per-UE pilot-pair centres)."""
    span_pat = dmrs_mod.dmrs_pattern(1, cell.nof_ue * cell.prb_per_ue, port=port)
    pat = dmrs_mod.dmrs_pattern(1, cell.prb_per_ue, port=port)
    centers = (pat.subcarriers[0::2] + pat.subcarriers[1::2]) // 2
    return span_pat.subcarriers, np.asarray(span_pat.wf), centers


@functools.lru_cache(maxsize=None)
def _dmrs_rows_mimo(cell: CellConfig, device: torch.device) -> torch.Tensor:
    """(L, ndmrs, nsubc) DM-RS symbol rows per port: type-1 CDM pilots with
    the port's frequency OCC, zero elsewhere."""
    t = cell.timing
    band0 = cell.first_prb * N_SC_PER_PRB
    p0 = 6 * cell.first_prb
    pilots = _dmrs_full_band(cell, device)               # (ndmrs, 6*nof_prb)
    rows = torch.zeros((cell.n_layers, len(cell.dmrs_symbols), t.nof_subc),
                       dtype=torch.complex64, device=device)
    for p in range(cell.n_layers):
        sc_off, wf, _ = _span_dmrs(cell, p)
        wf_t = torch.as_tensor(wf, device=device)
        rows[p][:, torch.as_tensor(sc_off + band0, device=device)] = \
            pilots[:, p0:p0 + len(sc_off)] * wf_t
    return rows


def dl_slot_batch_mimo(payloads, rntis, cell: CellConfig, rv: int = 0,
                       extra_rows: torch.Tensor | None = None,
                       return_grid: bool = False,
                       device: str | torch.device = "cuda") -> torch.Tensor:
    """Multi-layer DL (or UE TX): (S, U, TBS_L) payloads -> (S, L, total)
    per-port samples, or with ``return_grid`` the (S, L, nsymb, nsubc)
    grids (a caller that merges grids modulates once).

    ``extra_rows``: optional (S, nsymb, nsubc) contribution added to port 0
    (control channels sent single-port on REs disjoint from the data band).
    DM-RS rides at data amplitude.
    """
    dev = resolve_device(device)
    payloads = torch.as_tensor(payloads, device=dev)
    rntis = torch.as_tensor(rntis, device=dev)
    n_l = cell.n_layers
    t = cell.timing
    s, u, tbs = payloads.shape
    w = cell.ue_width_sc
    span = u * w
    band0 = cell.first_prb * N_SC_PER_PRB
    ndata = len(cell.data_symbols)

    syms = _dl_code(payloads.reshape(s * u, tbs), rntis, cell, rv)
    # d(L*i + l) -> layer l: (S, U, ndata, w, L) -> (S, L, ndata, U*w).
    m5 = syms.reshape(s, u, ndata, w, n_l).to(torch.complex64)
    band = m5.permute(0, 4, 2, 1, 3).reshape(s, n_l, ndata, span)
    grid = torch.zeros((s, n_l, t.nsymb, t.nof_subc), dtype=torch.complex64,
                       device=dev)
    grid[:, :, list(cell.data_symbols), band0:band0 + span] = band
    grid[:, :, list(cell.dmrs_symbols)] = _dmrs_rows_mimo(cell, dev)
    if extra_rows is not None:
        grid[:, 0] += extra_rows.to(torch.complex64)
    if return_grid:
        return grid
    return ofdm.modulate_slot(grid, t, scale=1.0 / t.nfft)


def ul_slot_batch_mimo(rx_samples, rntis, cell: CellConfig, rv: int = 0,
                       num_iters: int = decoder.DEFAULT_ITERS,
                       soft_buffer=None, new_data=None, early_stop: bool = True,
                       device: str | torch.device = "cuda"):
    """Multi-antenna UL: (S, P, total) samples -> (payload (S, U, TBS_L),
    tb_ok (S, U), noise_var (S, U), cfo (S, U), soft (S, U*C, n_cb)), with
    the HARQ contract of ``ul_slot_batch``."""
    dev = resolve_device(device)
    rx_samples = torch.as_tensor(rx_samples, device=dev)
    rntis = torch.as_tensor(rntis, device=dev)
    s, u = rx_samples.shape[0], cell.nof_ue
    seg, _ = _plans(cell, rv)
    llr, nv, cfo = _ul_front_mimo(rx_samples, rntis, cell)
    sb_flat, nd_flat = _harq_flat(soft_buffer, new_data, cell, s, dev)
    payload, tb_ok, soft = _ul_back(llr, cell, rv, num_iters, sb_flat, nd_flat,
                                    early_stop=early_stop)
    return (payload.reshape(s, u, -1), tb_ok.reshape(s, u), nv, cfo,
            soft.reshape(s, u * seg.c, -1))


def _ul_front_mimo(rx_samples: torch.Tensor | None, rntis: torch.Tensor,
                   cell: CellConfig, rx_grid: torch.Tensor | None = None):
    """Multi-antenna UL front: (S, P, total) samples, or a demodulated
    (S, P, nsymb, nsubc) ``rx_grid`` -> ((S*U, L*G) LLRs, (S, U) noise_var,
    (S, U) cfo).

    Per (antenna, CDM group) the pilots are OCC-despread, (u ± v)/2 over
    pilot pairs, into half-rate virtual pilots for ``estimate_port``; the
    CFO is the angle of the correlations summed over streams and antennas;
    the LxP MMSE weights are computed once per subcarrier and applied to
    every data symbol; the layer axis stays minor, so expanding it by Qm is
    the layer interleave."""
    n_l = cell.n_layers
    t = cell.timing
    u, w = cell.nof_ue, cell.ue_width_sc
    span = u * w
    band0 = cell.first_prb * N_SC_PER_PRB
    ndata = len(cell.data_symbols)
    ndmrs = len(cell.dmrs_symbols)

    if rx_grid is None:
        s, p_rx, total = rx_samples.shape
        rx_grid = ofdm.demodulate_slot(rx_samples.reshape(s * p_rx, total), t,
                                       scale=1.0)
        rx_grid = rx_grid.reshape(s, p_rx, t.nsymb, t.nof_subc)
    else:
        s, p_rx = rx_grid.shape[:2]
    dev = rx_grid.device
    band = rx_grid[..., band0:band0 + span]                   # (S, P, nsymb, span)

    pilots = _dmrs_full_band(cell, dev)
    p0 = 6 * cell.first_prb
    times = np.asarray([t.cp.data_starts[l] for l in cell.dmrs_symbols]) / t.srate
    times_opt = times if ndmrs > 1 else None

    hs, nvs, cfos = [], [], []      # per port (layer): (S, P, U, w), (S, P, U)
    for grp in range((n_l + 1) // 2):
        sc_off, _, centers = _span_dmrs(cell, 2 * grp)
        npil = len(sc_off)
        if not (sc_off == np.arange(grp, span, 2)).all():
            raise ValueError("pipeline assumes type-1 DM-RS (CDM group g on "
                             "subcarriers g::2)")
        npil_ue = npil // u
        rx_p = band[:, :, list(cell.dmrs_symbols), grp::2]   # (S, P, ndmrs, npil)
        rx_p = rx_p.reshape(s * p_rx, ndmrs, u, npil_ue).transpose(1, 2)
        ref = pilots[:, p0:p0 + npil].reshape(ndmrs, u, npil_ue).transpose(0, 1)
        raw = (rx_p * torch.conj(ref)).reshape(s * p_rx * u, ndmrs, npil_ue)
        u_, v_ = raw[..., 0::2], raw[..., 1::2]
        ones = torch.ones_like(u_)
        for sign in (1.0, -1.0):
            hp = (u_ + sign * v_) / 2
            h, nv, _ = channel_est.estimate_port(hp, ones, centers, w,
                                                 dmrs_symbol_times_s=times_opt)
            hs.append(h.reshape(s, p_rx, u, w))
            nvs.append(nv.reshape(s, p_rx, u))
            cfos.append(channel_est.cfo_correlation(hp).reshape(s, p_rx, u))
    h = torch.stack(hs[:n_l], dim=2)                          # (S, P, L, U, w)
    nv = sum(nvs[:n_l]) / n_l                                 # (S, P, U)
    dt = float(np.float32(times[-1] - times[0])) if ndmrs > 1 else 1.0
    cfo = (torch.angle(torch.sum(sum(cfos), dim=1))          # (S, U)
           / float(np.float32(2.0 * np.pi)) / dt).to(torch.float32)

    y = band[:, :, list(cell.data_symbols)].reshape(s, p_rx, ndata, u, w)
    # The pilots were derotated by their symbol times; each data symbol
    # still carries e^{j2pi*cfo*t_l} (float32 phase, as the reference).
    if ndmrs > 1:
        t_data = torch.as_tensor(
            np.asarray([t.cp.data_starts[l] for l in cell.data_symbols],
                       np.float32) / np.float32(t.srate), device=dev)
        ph = float(np.float32(-2.0 * np.pi)) * cfo[:, None, :] \
            * t_data[None, :, None]                            # (S, n, U)
        y = y * torch.complex(torch.cos(ph), torch.sin(ph))[:, None, :, :, None]
    # Noise floor: a zero estimate (noiseless loopback) would blow the
    # whitening up into all-zero equaliser outputs, whose all-zero codeword
    # passes parity.
    nv_p = torch.clamp(nv[..., None], min=1e-9)               # (S, P, U, 1)
    x_hat, nv_out = equalizer.mmse_equalize_timeinv_grid(y, h, nv_p)
    x5 = x_hat.permute(0, 2, 1, 3, 4)                         # (S, U, n, w, L)
    nv5 = nv_out[:, :, None].expand(x5.shape)                 # (S, U, n, w, L)
    llr = modulation.demodulate_soft(x5, nv5, cell.modulation, quantize=False)
    llr = modulation.wire_quantize(llr, cell.modulation).reshape(s * u, -1)
    llr = sequences.scramble_llrs(llr, _scrambling_inits(rntis, cell, s))
    return llr, torch.mean(nv, dim=1), cfo
