"""Cell slot pipeline, SISO data plane: multi-UE DL encode + UL decode.

Port of the SISO part of ``srsran_edgeric_5g_tpu/parallel/slot_pipeline.py``.
One call processes a batch of slots for all UEs of a cell.  UE allocations
are uniform-width and contiguous from a static first PRB, so every per-UE
gather/scatter is a slice + reshape.  The reference's mesh sharding has no
counterpart here: on one card the UE and codeblock axes are plain batch
dimensions.

DL: segment -> LDPC encode -> rate match -> scramble -> modulate -> place
subgrids -> OFDM modulate.  UL: OFDM demod -> DM-RS estimate -> MMSE
equalize -> demap -> wire quantise -> descramble -> rate dematch (+ HARQ
combine into the int8 soft carry) -> LDPC decode (the CUDA kernel on the
card) -> TB CRC.

The entry points (``dl_slot``, ``dl_slot_batch``, ``ul_slot``,
``ul_slot_batch``) take ``device`` ("cuda" by default) and move their inputs
there; a CUDA request on a host without a CUDA device raises.
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
    # estimator (not ported yet: raises).
    delay_spread_us: float = 0.0
    # Limited-buffer rate matching: 0 = full buffer; > 0 = TBS_LBRM bits.
    tbs_lbrm: int = 0
    # Spatial layers per UE; this slice ports the SISO pipeline (1).
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
    if cell.n_layers != 1:
        raise NotImplementedError("the MIMO slot pipeline (n_layers > 1) is "
                                  "not ported yet")
    if cell.delay_spread_us > 0:
        raise NotImplementedError("estimate_port_ta (delay_spread_us > 0) is "
                                  "not ported yet")


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


def _dl_code(payloads: torch.Tensor, rntis: torch.Tensor, cell: CellConfig,
             rv: int = 0) -> torch.Tensor:
    """Coding front-end for a flat (B_tb, TBS) batch -> (B_tb, G/Qm) symbols:
    all codeblocks of all TBs go through segment -> encode -> rate match ->
    scramble -> modulate as one batch."""
    seg, rm = _plans(cell, rv)
    b_tb = payloads.shape[0]
    cbs = segmenter.segment_tb(payloads, seg)                 # (B_tb*C, K)
    cw = encoder.encode(cbs, seg.bg, seg.zc)                  # (B_tb*C, colsZc)
    bits = rate_match.rate_match(cw, rm).reshape(b_tb, -1)    # (B_tb, G)
    bits = sequences.scramble_bits(
        bits, _scrambling_inits(rntis, cell, b_tb // cell.nof_ue))
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
    sb_flat = None if soft_buffer is None else \
        torch.as_tensor(soft_buffer, device=dev).reshape(s * u * seg.c, -1)
    nd_flat = None if new_data is None else \
        torch.as_tensor(new_data, device=dev).reshape(s * u)
    payload, tb_ok, soft = _ul_back(llr.reshape(s * u, -1), cell, rv,
                                    num_iters, sb_flat, nd_flat)
    return (payload.reshape(s, u, -1), tb_ok.reshape(s, u), nv, cfo,
            soft.reshape(s, u * seg.c, -1))


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


def _ul_front(rx_samples: torch.Tensor | None, rntis: torch.Tensor,
              cell: CellConfig, rx_grid: torch.Tensor | None = None):
    """OFDM demod -> chest -> MMSE -> demap -> wire quantise -> descramble:
    (S, total) samples -> ((S, U, G) LLRs, (S, U) noise_var, (S, U) cfo).
    ``rx_grid`` (S, nsymb, nsubc) skips the OFDM demodulation when the
    caller already demodulated the slots (the full cell shares one grid
    between PUSCH, PUCCH and SRS)."""
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
    llr = sequences.scramble_llrs(llr, _scrambling_inits(rntis, cell, s))
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
