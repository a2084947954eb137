"""PUSCH transmit and receive processors for one UE.

Port of ``srsran_edgeric_5g_tpu/models/pusch.py`` (the reference's
pusch_processor_impl.cpp, pusch_demodulator_impl.cpp, pusch_decoder_impl.cpp):
DM-RS channel estimation -> MMSE equalisation -> max-log soft demap -> wire
quantise -> descramble -> UCI demultiplex -> rate dematch (with HARQ soft
combining into a float32 buffer) -> layered min-sum LDPC decode ->
TB CRC.  The decode is ``decode(schedule="wire_auto")``: on a CUDA tensor
the hand-written kernel in wire mode (``ops/ldpc/decoder_cuda``).

The configuration shares ``PdschConfig``'s allocation geometry.  With
``dmrs_beta=1.0`` and no UCI the same chain is the UE-side PDSCH receiver
(``models.pdsch.receive``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import channel_est, equalizer, modulation, precoding, sequences, \
    ulsch_demux
from ..ops import dmrs as dmrs_mod
from ..ops import uci as uci_ops
from ..ops.ldpc import decoder, rate_match, segmenter
from ..ran.numerology import N_SC_PER_PRB
from . import pdsch as pdsch_mod
from .pdsch import PdschConfig, _plans, c_init_on, cb_runs, grid_layout

# DM-RS 3 dB above data (2 CDM groups without data, TS 38.214).
PUSCH_DMRS_BETA = float(np.sqrt(2.0))


@dataclasses.dataclass(frozen=True)
class UciConfig:
    """UCI piggybacked on PUSCH (TS 38.212 §6.2.7).

    n_* are payload bits (short block for <= 11, polar CA-SCL for >= 12,
    ``ops.uci``); g_* are the coded bit counts reserved on the PUSCH."""

    n_ack: int = 0
    g_ack: int = 0
    n_csi1: int = 0
    g_csi1: int = 0
    g_ack_rvd: int = 0   # reserved REs (o_ack <= 2 puncture mode)
    n_csi2: int = 0
    g_csi2: int = 0


def _uci_plan(cfg: PdschConfig, uci: UciConfig):
    return ulsch_demux.get_demux_plan(
        cfg.g_total, cfg.qm, cfg.nof_prb * N_SC_PER_PRB,
        cfg.data_symbols, cfg.dmrs_symbols[0], uci.g_ack, uci.g_csi1,
        g_ack_rvd=uci.g_ack_rvd, o_ack=uci.n_ack if uci.n_ack else 3,
        g_csi2=uci.g_csi2)


def transmit(payload: torch.Tensor, cfg: PdschConfig, nsymb: int, nsubc: int,
             rv: int = 0, uci: UciConfig | None = None,
             ack_bits: torch.Tensor | None = None,
             csi1_bits: torch.Tensor | None = None,
             csi2_bits: torch.Tensor | None = None) -> torch.Tensor:
    """UE-side PUSCH transmit: UL-SCH (+ UCI multiplexing) -> grid.

    Without UCI the chain is ``pdsch.process``'s with the PUSCH DM-RS boost;
    with UCI the coded ACK / CSI bits take their PUSCH positions before
    scrambling."""
    if uci is None:
        bits = pdsch_mod.encode_transport_block(payload, cfg, rv)
    else:
        # The UL-SCH rate-matches to G_sch = len(plan.sch_positions): G - G_uci
        # in the skip mode (o_ack > 2), the full G in the reserved mode (the
        # ACK then punctures its reserved subset).
        plan = _uci_plan(cfg, uci)
        bits = pdsch_mod.encode_transport_block(payload, cfg, rv,
                                                scramble=False,
                                                e_total=plan.sch_len)
        ack_c = uci_ops.encode(ack_bits, uci.g_ack) if uci.n_ack else None
        csi_c = uci_ops.encode(csi1_bits, uci.g_csi1) if uci.n_csi1 else None
        csi2_c = uci_ops.encode(csi2_bits, uci.g_csi2) if uci.n_csi2 else None
        bits = ulsch_demux.multiplex(bits, plan, ack_c, csi_c, csi2_c)
        bits = sequences.scramble_bits(bits, c_init_on(cfg.rnti, cfg.n_id,
                                                       bits.device))
    syms = modulation.modulate(bits, cfg.modulation)
    if cfg.transform_precoding:
        syms = precoding.transform_precode(syms, cfg.nof_prb * N_SC_PER_PRB)
    return pdsch_mod.map_to_grid(syms, cfg, nsymb, nsubc,
                                 dmrs_scale=PUSCH_DMRS_BETA)


@dataclasses.dataclass
class PuschResult:
    payload: torch.Tensor        # (1, TBS) decoded bits
    tb_crc_ok: torch.Tensor      # (1,) bool
    cb_crc_ok: torch.Tensor      # (C,) bool per-codeblock parity
    soft_buffer: torch.Tensor | None   # (C, N_cb) accumulated LLRs (HARQ)
    noise_var: torch.Tensor      # scalar estimated noise variance
    cfo_hz: torch.Tensor         # scalar estimated CFO
    evm_sinr_db: torch.Tensor    # scalar post-equalisation SINR estimate
    ack_bits: torch.Tensor | None = None   # (1, n_ack) detected HARQ-ACK
    csi1_bits: torch.Tensor | None = None  # (1, n_csi1) detected CSI part 1
    csi2_bits: torch.Tensor | None = None  # (1, n_csi2) detected CSI part 2


@functools.lru_cache(maxsize=None)
def _data_times(cfg: PdschConfig, symbol_times: tuple,
                device: torch.device) -> torch.Tensor:
    """(ndata,) float32 start times of the data symbols on ``device``."""
    return torch.as_tensor(np.asarray([symbol_times[l] for l in cfg.data_symbols],
                                      np.float32), device=device)


def channel_estimate(rx_grid: torch.Tensor, cfg: PdschConfig, srate: float,
                     symbol_times: np.ndarray, scs_hz: float = 15e3,
                     delay_spread_s: float | None = None,
                     dmrs_beta: float = PUSCH_DMRS_BETA):
    """Estimate the allocation's channel from the configured DM-RS symbols.

    rx_grid: (nsymb, nsubc).  Returns (h (width,), noise_var (), cfo ()).
    ``delay_spread_s`` selects the TA + smoothing estimator
    (``estimate_port_ta``).  ``dmrs_beta``, the transmitted DM-RS-to-data
    amplitude ratio, is undone before the LS estimate: sqrt(2) for PUSCH,
    1.0 for the DL."""
    width = cfg.nof_prb * N_SC_PER_PRB
    pat = dmrs_mod.dmrs_pattern(1, cfg.nof_prb, port=0)
    lay = grid_layout(cfg, rx_grid.device)
    undo = float(np.float32(1.0 / dmrs_beta))
    rx_pilots = torch.stack([rx_grid[l, lay.pilot_sc] * undo
                             for l in cfg.dmrs_symbols])[None]  # (1, ndmrs, npil)
    ref_pilots = torch.stack(lay.pilots)[None]
    times = np.asarray([symbol_times[l] for l in cfg.dmrs_symbols])
    times = times if len(cfg.dmrs_symbols) > 1 else None
    if delay_spread_s is not None:
        h, nv, cfo, _ = channel_est.estimate_port_ta(
            rx_pilots, ref_pilots, pat.subcarriers, width, scs_hz,
            dmrs_symbol_times_s=times, delay_spread_s=delay_spread_s)
    else:
        h, nv, cfo = channel_est.estimate_port(
            rx_pilots, ref_pilots, pat.subcarriers, width,
            dmrs_symbol_times_s=times)
    return h[0], nv[0], cfo[0]


def equalize(rx_grid: torch.Tensor, cfg: PdschConfig, h: torch.Tensor,
             nv: torch.Tensor, cfo: torch.Tensor, symbol_times: np.ndarray):
    """DC zeroing, CFO ramp and MMSE 1x1 of the data REs, then the
    DFT-s-OFDM despread: -> (x_hat (ndata, width), nv_out (ndata, width))."""
    sc0 = cfg.start_prb * N_SC_PER_PRB
    width = cfg.nof_prb * N_SC_PER_PRB
    lay = grid_layout(cfg, rx_grid.device)
    # DC-position zeroing: a zero channel estimate makes the equaliser treat
    # the DC RE as an invalid port -> x_hat 0, nvar inf -> zero LLRs.
    if cfg.dc_position is not None and sc0 <= cfg.dc_position < sc0 + width:
        h = h.clone()
        h[cfg.dc_position - sc0] = 0
    y = rx_grid[lay.data_symbols, sc0:sc0 + width]     # (ndata, width)
    # CFO: the estimate is anchored at t = 0 (the pilots were derotated by
    # their symbol times), so each data symbol still rotates by
    # e^{j2pi*cfo*t_l}.  With one DM-RS symbol there is no CFO estimate.
    if len(cfg.dmrs_symbols) > 1:
        t_data = _data_times(cfg, tuple(float(x) for x in symbol_times),
                             rx_grid.device)
        ph = float(np.float32(-2.0 * np.pi)) * cfo * t_data
        y = y * torch.complex(torch.cos(ph), torch.sin(ph))[:, None]
    hh = h.expand(y.shape)
    x_hat, nv_out = equalizer.equalize_mmse_1xn(y[None], hh[None],
                                                nv[None, None])
    if cfg.transform_precoding:
        # iDFT despread per data symbol; the block iDFT whitens the per-RE
        # noise, so demap with the block-average variance.
        x_hat = precoding.transform_deprecode(x_hat, width)
        nv_out = torch.mean(nv_out, dim=-1, keepdim=True).expand(nv_out.shape)
    return x_hat, nv_out


def demap(x_hat: torch.Tensor, nv_out: torch.Tensor,
          cfg: PdschConfig) -> torch.Tensor:
    """Soft demap with per-RE noise variance, wire quantise (float dtype),
    descramble: -> (1, G) wire LLRs."""
    llr = modulation.demodulate_soft(x_hat.reshape(1, -1),
                                     nv_out.reshape(1, -1),
                                     cfg.modulation, quantize=False)
    llr = modulation.wire_quantize(llr, cfg.modulation)
    return sequences.scramble_llrs(llr, c_init_on(cfg.rnti, cfg.n_id,
                                                  llr.device))


def dematch(llr: torch.Tensor, seg, rms,
            soft_buffer: torch.Tensor | None = None) -> torch.Tensor:
    """(1, G_sch) LLRs -> (C, cols*Zc) float32 decoder input, combined into
    the float32 HARQ buffer (C, N_cb) when given (no saturation: the sum of
    wire integers stays an integer)."""
    full, off = [], 0
    for i0, i1, plan in cb_runs(seg, rms):
        n = (i1 - i0) * plan.e
        prev = None if soft_buffer is None else soft_buffer[i0:i1]
        full.append(rate_match.rate_dematch(
            llr[:, off:off + n].reshape(i1 - i0, plan.e), plan, prev))
        off += n
    return full[0] if len(full) == 1 else torch.cat(full, dim=0)


def process(rx_grid: torch.Tensor, cfg: PdschConfig, srate: float,
            symbol_times: np.ndarray, rv: int = 0,
            soft_buffer: torch.Tensor | None = None,
            num_iters: int = decoder.DEFAULT_ITERS,
            scs_hz: float = 15e3,
            delay_spread_s: float | None = None,
            uci: UciConfig | None = None,
            dmrs_beta: float = PUSCH_DMRS_BETA) -> PuschResult:
    """Full PUSCH receive for one UE from an (nsymb, nsubc) rx grid."""
    plan_u = _uci_plan(cfg, uci) if uci is not None else None
    seg, rms = _plans(cfg, rv, plan_u.sch_len if plan_u is not None else None)

    h, nv, cfo = channel_estimate(rx_grid, cfg, srate, symbol_times,
                                  scs_hz, delay_spread_s, dmrs_beta)
    x_hat, nv_out = equalize(rx_grid, cfg, h, nv, cfo, symbol_times)
    llr = demap(x_hat, nv_out, cfg)

    # UCI on PUSCH: pull the ACK / CSI LLRs out, erase their SCH positions.
    ack_bits = csi1_bits = csi2_bits = None
    if uci is not None:
        llr, ack_llr, csi_llr, csi2_llr = ulsch_demux.demultiplex(llr, plan_u)
        if uci.n_ack:
            ack_bits, _ = uci_ops.decode(ack_llr, uci.n_ack, uci.g_ack)
        if uci.n_csi1:
            csi1_bits, _ = uci_ops.decode(csi_llr, uci.n_csi1, uci.g_csi1)
        if uci.n_csi2:
            csi2_bits, _ = uci_ops.decode(csi2_llr, uci.n_csi2, uci.g_csi2)

    full_llrs = dematch(llr, seg, rms, soft_buffer)      # (C, cols*Zc)
    # HARQ state: the accumulated circular buffer.
    zc = seg.zc
    new_soft = full_llrs[:, 2 * zc:2 * zc + rms[0].n_cb]
    hard, cb_ok = decoder.decode(full_llrs, seg.bg, seg.zc,
                                 num_iters=num_iters, schedule="wire_auto")
    payload, tb_ok = segmenter.desegment_tb(hard, seg)

    mean_nv = torch.mean(torch.where(torch.isfinite(nv_out), nv_out, 1.0))
    sinr = 10.0 * torch.log10(torch.clamp(
        1.0 / torch.clamp(mean_nv, min=1e-9), min=1e-9))
    return PuschResult(payload=payload, tb_crc_ok=tb_ok, cb_crc_ok=cb_ok,
                       soft_buffer=new_soft, noise_var=nv, cfo_hz=cfo,
                       evm_sinr_db=sinr, ack_bits=ack_bits,
                       csi1_bits=csi1_bits, csi2_bits=csi2_bits)
