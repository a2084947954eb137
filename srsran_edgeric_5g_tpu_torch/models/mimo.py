"""Multi-layer (2 / 4) MIMO PDSCH / PUSCH for one UE.

Port of ``srsran_edgeric_5g_tpu/models/mimo.py``: the multi-port path of
the reference's resource grid, identity precoding (port p = layer p), the
type-1 DM-RS CDM groups (frequency OCC) and the LxN MMSE equalisers.

TX: one TB encoded at the L-layer TBS -> layer mapping d(L*i + l) -> layer
l (TS 38.211 §7.3.1.3) -> per-port grids with CDM DM-RS: ports 0/1 share
CDM group 0's subcarriers with OCC [+,+] / [+,-]; ports 2/3 (L = 4) share
CDM group 1 (delta = 1).

RX: per (rx antenna, tx port) channel estimation by OCC de-spreading pilot
pairs within each CDM group (half-rate virtual pilots at the pair centres,
through the single-port estimator's interpolation), then the weights-once
MMSE (``equalizer.mmse_equalize_timeinv``), layer demapping, demap,
descramble, dematch and the LDPC decode with the reference's default
schedule, ``decode(schedule="auto")``: on a CUDA tensor the hand-written
kernel's f32 mode (``ops/ldpc/decoder_cuda``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import channel_est, equalizer, modulation, sequences
from ..ops import dmrs as dmrs_mod
from ..ops.ldpc import decoder, encoder, rate_match, segmenter
from ..ran.numerology import N_SC_PER_PRB
from ..ran.tbs import nof_re, tbs as tbs_calc
from .pdsch import PdschConfig, c_init_on, cb_runs, grid_layout
from .pusch import PuschResult, _data_times, dematch

N_LAYERS = 2


def derived_tbs(cfg: PdschConfig, n_layers: int = N_LAYERS) -> int:
    nre = nof_re(cfg.nof_prb, cfg.nof_symbols, 12 * len(cfg.dmrs_symbols))
    return tbs_calc(nre, cfg.target_rate, cfg.qm, n_layers)


@functools.lru_cache(maxsize=None)
def _plans(cfg: PdschConfig, rv: int, n_layers: int):
    tbs_l = derived_tbs(cfg, n_layers)
    g_l = n_layers * cfg.g_total
    bg = segmenter.select_base_graph(tbs_l, cfg.target_rate)
    seg = segmenter.get_segment_plan(tbs_l, bg, g_l, cfg.qm)
    rms = tuple(rate_match.get_rate_match_plan(seg.bg, seg.zc, e, rv, cfg.qm,
                                               seg.k_prime)
                for e in sorted(set(seg.e)))
    return seg, rms


def _plans2(cfg: PdschConfig, rv: int = 0):
    return _plans(cfg, rv, N_LAYERS)


def _encode(payload: torch.Tensor, cfg: PdschConfig, rv: int,
            n_layers: int) -> torch.Tensor:
    """(1, TBS_L) -> (1, L*G) scrambled codeword bits (one codeword)."""
    seg, rms = _plans(cfg, rv, n_layers)
    cbs = segmenter.segment_tb(payload, seg)
    cw = encoder.encode(cbs, seg.bg, seg.zc)
    bits = torch.cat([rate_match.rate_match(cw[i0:i1], plan).reshape(-1)
                      for i0, i1, plan in cb_runs(seg, rms)])[None, :]
    return sequences.scramble_bits(bits, c_init_on(cfg.rnti, cfg.n_id,
                                                   bits.device))


def layer_map(syms: torch.Tensor, n_layers: int = N_LAYERS) -> torch.Tensor:
    """(1, LM) codeword symbols -> (L, M): d(L*i + l) -> layer l."""
    return syms.reshape(-1, n_layers).T


def layer_demap(x: torch.Tensor) -> torch.Tensor:
    """(L, M) layer values -> (1, LM) codeword order."""
    return x.T.reshape(1, -1)


@functools.lru_cache(maxsize=None)
def _port_pilots(cfg: PdschConfig, port: int, device: torch.device):
    """(grid subcarriers (npil,), per DM-RS symbol the pilots * w_f) of one
    port on ``device``."""
    pat = dmrs_mod.dmrs_pattern(1, cfg.nof_prb, port=port)
    sc0 = cfg.start_prb * N_SC_PER_PRB
    wf = torch.as_tensor(pat.wf, device=device)
    vals = []
    for l in cfg.dmrs_symbols:
        ci = torch.tensor([dmrs_mod.dmrs_c_init(cfg.slot, l, cfg.n_id, cfg.n_scid)],
                          dtype=torch.int64, device=device)
        pil = dmrs_mod.dmrs_sequence(ci, len(pat.subcarriers),
                                     skip_pilots=6 * cfg.start_prb)[0]
        vals.append((pil, pil * wf))
    return torch.as_tensor(pat.subcarriers + sc0, device=device), tuple(vals)


def process_mimo(payload: torch.Tensor, cfg: PdschConfig, nsymb: int,
                 nsubc: int, rv: int = 0,
                 n_layers: int = N_LAYERS) -> torch.Tensor:
    """(1, TBS_L) payload -> (L, nsymb, nsubc) per-port grids."""
    dev = payload.device
    bits = _encode(payload, cfg, rv, n_layers)
    syms = modulation.modulate(bits, cfg.modulation)      # (1, LM)
    layers = layer_map(syms, n_layers)                    # (L, M)
    sc0 = cfg.start_prb * N_SC_PER_PRB
    width = cfg.nof_prb * N_SC_PER_PRB
    sym_idx = grid_layout(cfg, dev).data_symbols
    grids = torch.zeros((n_layers, nsymb, nsubc), dtype=torch.complex64,
                        device=dev)
    for p in range(n_layers):
        data = layers[p].reshape(len(cfg.data_symbols), width)
        grids[p, sym_idx, sc0:sc0 + width] = data.to(torch.complex64)
        sc, vals = _port_pilots(cfg, p, dev)
        for l, (_, pil_wf) in zip(cfg.dmrs_symbols, vals):
            grids[p, l, sc] = pil_wf
    return grids


def process_2layer(payload: torch.Tensor, cfg: PdschConfig, nsymb: int,
                   nsubc: int, rv: int = 0) -> torch.Tensor:
    """(1, TBS2) payload -> (2, nsymb, nsubc) per-port grids."""
    return process_mimo(payload, cfg, nsymb, nsubc, rv, N_LAYERS)


def _estimate_ports_occ(rx_grid: torch.Tensor, cfg: PdschConfig,
                        symbol_times: np.ndarray, cdm_group: int = 0):
    """One rx antenna -> the 2 tx ports of one CDM group by OCC de-spread.

    Ports 2g / 2g+1 share CDM group g's subcarriers with w_f = [+,+] / [+,-]
    over pilot pairs: u = r(2j)/p(2j), v = r(2j+1)/p(2j+1) give h_even =
    (u+v)/2 and h_odd = (u-v)/2 at the pair centre, which feed the standard
    estimator's interpolation.  Returns ((2, width) h, noise_var, the
    summed complex CFO correlation)."""
    width = cfg.nof_prb * N_SC_PER_PRB
    pat = dmrs_mod.dmrs_pattern(1, cfg.nof_prb, port=2 * cdm_group)
    sc, vals = _port_pilots(cfg, 2 * cdm_group, rx_grid.device)
    r = torch.stack([rx_grid[l, sc] for l in cfg.dmrs_symbols])[None]
    p = torch.stack([pil for pil, _ in vals])[None]        # (1, ndmrs, npil)
    raw = r * torch.conj(p) / torch.clamp(torch.abs(p) ** 2, min=1e-12)
    u, v = raw[..., 0::2], raw[..., 1::2]                   # pilot pairs
    centers = (pat.subcarriers[0::2] + pat.subcarriers[1::2]) // 2
    times = (np.asarray([symbol_times[l] for l in cfg.dmrs_symbols])
             if len(cfg.dmrs_symbols) > 1 else None)
    ones = torch.ones_like(u)
    hs, nvs, corrs = [], [], []
    for hp in ((u + v) / 2, (u - v) / 2):
        h, nv, _ = channel_est.estimate_port(hp, ones, centers, width,
                                             dmrs_symbol_times_s=times)
        hs.append(h[0])
        nvs.append(nv[0])
        # The complex CFO correlation, not the per-stream angle: a dead
        # stream (a zero cross-channel entry) has noise-only pilots whose
        # angle is random; summing correlations weights it by its energy.
        corrs.append(channel_est.cfo_correlation(hp)[0])
    return torch.stack(hs), (nvs[0] + nvs[1]) / 2, corrs[0] + corrs[1]


def decoder_input(rx_grids: torch.Tensor, cfg: PdschConfig,
                  symbol_times: np.ndarray, rv: int = 0,
                  n_layers: int = N_LAYERS):
    """The receiver up to the decoder: OCC estimates, CFO, weights-once
    MMSE, demap, descramble and dematch of (n_rx, nsymb, nsubc) antenna
    grids -> ((C, cols*Zc) float32 LLRs, (n_rx,) noise variances, cfo)."""
    seg, rms = _plans(cfg, rv, n_layers)
    dev = rx_grids.device
    n_rx = rx_grids.shape[0]
    sc0 = cfg.start_prb * N_SC_PER_PRB
    width = cfg.nof_prb * N_SC_PER_PRB
    n_groups = (n_layers + 1) // 2

    hs, nvs, corrs = [], [], []
    for a in range(n_rx):
        per_group_h, per_group_nv = [], []
        for g in range(n_groups):
            h, nv, corr = _estimate_ports_occ(rx_grids[a], cfg, symbol_times,
                                              cdm_group=g)
            per_group_h.append(h)
            per_group_nv.append(nv)
            corrs.append(corr)
        hs.append(torch.cat(per_group_h, dim=0)[:n_layers])
        nvs.append(sum(per_group_nv) / n_groups)
    h = torch.stack(hs)                          # (n_rx, L, width)
    nv = torch.stack(nvs)                        # (n_rx,)

    # Energy-weighted CFO over every (antenna, OCC stream) correlation.
    cfo = torch.zeros((), dtype=torch.float32, device=dev)
    if len(cfg.dmrs_symbols) > 1:
        dt = float(symbol_times[cfg.dmrs_symbols[-1]]
                   - symbol_times[cfg.dmrs_symbols[0]])
        cfo = (torch.angle(sum(corrs))
               / float(np.float32(2.0 * np.pi * dt))).to(torch.float32)

    y = rx_grids[:, grid_layout(cfg, dev).data_symbols, sc0:sc0 + width]
    # CFO compensation of the data symbols (estimates anchored at t = 0).
    if len(cfg.dmrs_symbols) > 1:
        t_data = _data_times(cfg, tuple(float(x) for x in symbol_times), dev)
        ph = float(np.float32(-2.0 * np.pi)) * cfo * t_data
        y = y * torch.complex(torch.cos(ph), torch.sin(ph))[None, :, None]
    # Weights once per subcarrier (the channel is constant across the data
    # symbols); demap layer-major, then interleave the LLRs into codeword
    # order.
    nv_p = torch.clamp(nv[:, None, None], min=1e-30)        # (P, 1, 1)
    x_hat, nv_out = equalizer.mmse_equalize_timeinv(
        y[:, None], h[:, :, None], nv_p)                    # (1, L, ndata, w)
    ndata_n, w_n = y.shape[1], y.shape[2]
    qm = cfg.qm
    x = x_hat.reshape(n_layers, ndata_n * w_n)
    nv_x = nv_out[0, :, None, :].expand(n_layers, ndata_n, w_n
                                        ).reshape(n_layers, ndata_n * w_n)
    llr = modulation.demodulate_soft(x, nv_x, cfg.modulation,
                                     quantize=False)        # (L, nw*Qm)
    llr = llr.reshape(n_layers, ndata_n * w_n, qm).permute(1, 0, 2)
    llr = llr.reshape(1, -1)
    llr = sequences.scramble_llrs(llr, c_init_on(cfg.rnti, cfg.n_id, dev))

    return dematch(llr, seg, rms), nv, cfo


def receive_mimo(rx_grids: torch.Tensor, cfg: PdschConfig, srate: float,
                 symbol_times: np.ndarray, rv: int = 0,
                 num_iters: int = decoder.DEFAULT_ITERS,
                 n_layers: int = N_LAYERS) -> PuschResult:
    """(n_rx, nsymb, nsubc) antenna grids -> decoded L-layer TB."""
    seg, _ = _plans(cfg, rv, n_layers)
    full, nv, cfo = decoder_input(rx_grids, cfg, symbol_times, rv, n_layers)
    hard, cb_ok = decoder.decode(full, seg.bg, seg.zc, num_iters=num_iters,
                                 schedule="auto")
    payload, tb_ok = segmenter.desegment_tb(hard, seg)
    mean_nv = torch.mean(nv)
    sinr = -10.0 * torch.log10(torch.clamp(mean_nv, min=1e-9))
    return PuschResult(payload=payload, tb_crc_ok=tb_ok, cb_crc_ok=cb_ok,
                       soft_buffer=None, noise_var=mean_nv,
                       cfo_hz=cfo, evm_sinr_db=sinr)


def receive_2layer(rx_grids: torch.Tensor, cfg: PdschConfig, srate: float,
                   symbol_times: np.ndarray, rv: int = 0,
                   num_iters: int = decoder.DEFAULT_ITERS) -> PuschResult:
    """(n_rx, nsymb, nsubc) antenna grids -> decoded 2-layer TB."""
    return receive_mimo(rx_grids, cfg, srate, symbol_times, rv, num_iters,
                        N_LAYERS)
