"""Cell-level upper-PHY orchestration: one object per cell, slot by slot.

Port of ``srsran_edgeric_5g_tpu/models/cell_processor.py``: the counterpart
of the reference's upper-PHY glue (upper_phy_impl,
downlink_processor_single_executor_impl.h:67-131 — process PDCCH/PDSCH/SSB
then send the grid — and uplink_processor_impl.cpp:70-154) plus the HARQ
rx-softbuffer pool (rx_buffer_pool_impl.cpp): the only cross-slot PHY state,
kept as tensors on the device keyed by (rnti, harq process).

The per-slot math is ``parallel.slot_pipeline``'s ``dl_slot`` / ``ul_slot``
(the UL decode is the LDPC kernel on the card); this layer sequences the
control channels, tracks HARQ state and reports metrics.  The reference's
mesh argument has no counterpart: one card holds the whole cell.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..ops import amplitude, csi_rs as csi_mod, ofdm, prach as prach_mod
from ..ops import pucch as pucch_mod
from ..parallel import slot_pipeline as sp
from ..utils.metrics import MetricsHub, SlotMetrics, UeSlotMetrics
from ..utils.tracing import l1_tracer
from . import pdcch as pdcch_mod, ssb as ssb_mod

NOF_HARQ = 8


@dataclasses.dataclass
class HarqProcess:
    """Per-(UE, pid) soft-combining state (reference rx_buffer)."""

    soft_buffer: torch.Tensor | None = None
    rv_sequence: tuple[int, ...] = (0, 2, 3, 1)
    tx_count: int = 0

    def next_rv(self) -> int:
        return self.rv_sequence[min(self.tx_count, len(self.rv_sequence) - 1)]

    def reset(self):
        self.soft_buffer = None
        self.tx_count = 0


class HarqPool:
    """rnti -> pid -> HarqProcess, the reference rx_buffer_pool equivalent."""

    def __init__(self):
        self._pool: dict[tuple[int, int], HarqProcess] = {}

    def get(self, rnti: int, pid: int) -> HarqProcess:
        key = (rnti, pid % NOF_HARQ)
        if key not in self._pool:
            self._pool[key] = HarqProcess()
        return self._pool[key]


class CellProcessor:
    """Slot-driven DL/UL processing for one cell, on ``device`` (CUDA by
    default; a CUDA request on a host without a card raises)."""

    def __init__(self, cell: sp.CellConfig, pci: int = 1,
                 ssb_period_slots: int = 20, metrics: MetricsHub | None = None,
                 tx_gain: float = 1.0, tx_ceiling: float = 0.0,
                 device: str | torch.device = "cuda"):
        self.cell = cell
        self.pci = pci
        self.ssb_period = ssb_period_slots
        self.metrics = metrics or MetricsHub()
        self.device = resolve_device(device)
        self.harq = HarqPool()
        # TX amplitude controller (reference: per-symbol scale/clip at the
        # lower-PHY baseband output, downlink_processor_baseband_impl +
        # amplitude_controller_{scaling,clipping}_impl).  ceiling 0 = scale
        # mode; > 0 = clipping mode.  Applied to every DL transmit; the
        # metrics land in SlotMetrics.tx_*.
        if tx_ceiling > 0:
            self._amp = lambda x: amplitude.clip(x, tx_gain, tx_ceiling)
        else:
            self._amp = lambda x: amplitude.scale(x, tx_gain)
        self._last_amp = None
        self._rnti_list = [0x4601 + u for u in range(cell.nof_ue)]
        self.rntis = torch.as_tensor(self._rnti_list, dtype=torch.int64,
                                     device=self.device)
        self.tbs = cell.derived_tbs()
        self._slot = 0

    def _on(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    # ------------------------------------------------------------------ DL

    def process_dl_slot(self, payloads, mib=None, dci=None,
                        rv: int = 0) -> torch.Tensor:
        """(U, TBS) payloads -> (total,) DL samples for this slot.

        Adds the SSB every ``ssb_period`` slots (when ``mib`` is given) and a
        PDCCH when ``dci`` is given — the downlink_processor 'process
        pdcch/pdsch/ssb then send' sequence.  ``rv`` drives HARQ
        retransmissions (rv_sequence 0, 2, 3, 1).
        """
        with l1_tracer.span("dl_slot", slot=self._slot):
            td = sp.dl_slot(self._on(payloads), self.rntis, self.cell, rv=rv,
                            device=self.device)
        # Control-channel grid contributions are modulated separately and
        # added in the time domain (disjoint REs -> additive grids).
        extra = None
        t = self.cell.timing
        if mib is not None and self._slot % self.ssb_period == 0:
            cfg = ssb_mod.SsbConfig(pci=self.pci, first_symbol=0,
                                    first_subcarrier=0)
            g = ssb_mod.process(self._on(mib), cfg, t.nsymb, t.nof_subc)
            extra = g if extra is None else extra + g
        if dci is not None:
            dci = self._on(dci)
            pcfg = pdcch_mod.PdcchConfig(rnti=self._rnti_list[0],
                                         n_id=self.cell.n_id,
                                         aggregation_level=4, cce_index=0,
                                         start_symbol=0,
                                         payload_bits=dci.shape[-1])
            g = pdcch_mod.process(dci, pcfg, t.nsymb, t.nof_subc)
            extra = g if extra is None else extra + g
        if extra is not None:
            td = td + ofdm.modulate_slot(extra, t, scale=1.0 / t.nfft)
        td, amp = self._amp(td)
        self._last_amp = amp
        return td

    # ------------------------------------------------------------------ UL

    def process_prach_occasion(self, rx_window, prach_cfg: prach_mod.PrachConfig
                               ) -> prach_mod.PrachDetection:
        """Detect preambles from a PRACH occasion's time samples.

        ``rx_window``: (cp + dft,) samples at the occasion position.  Returns
        the RACH indication the MAC would consume."""
        info = prach_mod.prach_ofdm_info(self.cell.timing.srate, prach_cfg.l_ra)
        freq = prach_mod.ofdm_demodulate_prach(self._on(rx_window), info)
        det = prach_mod.detect(freq, prach_cfg)
        if l1_tracer.enabled:
            delays = det.delays.cpu().numpy()
            for p in np.nonzero(det.detected.cpu().numpy())[0]:
                l1_tracer.instant("prach_detect", preamble=int(p),
                                  delay=int(delays[p]))
        return det

    def process_pucch(self, rx_grid, pucch_cfg: pucch_mod.Pucch2Config):
        """Decode a PUCCH F2 resource from an (nsymb, nsubc) rx grid."""
        return pucch_mod.format2_decode(self._on(rx_grid), pucch_cfg)

    def process_pucch_f0(self, rx_grid, cfg01: pucch_mod.Pucch01Config,
                         m0_candidates: tuple[int, ...]):
        """PUCCH F0 detection from the rx grid (pucch_detector_format0):
        slice the single-PRB resource, correlate the m0 hypotheses.  Returns
        (metrics, best_index)."""
        sc0 = cfg01.prb * 12
        rx = self._on(rx_grid)[cfg01.start_symbol:
                               cfg01.start_symbol + cfg01.nof_symbols,
                               sc0:sc0 + 12]
        return pucch_mod.format0_detect(rx, cfg01, m0_candidates)

    def process_pucch_f1(self, rx_grid, cfg01: pucch_mod.Pucch01Config,
                         nof_bits: int, occ_index: int = 0):
        """PUCCH F1 detection from the rx grid (pucch_detector_format1):
        despread the data symbols (the odd offsets; the DM-RS rides the even
        ones, TS 38.211 §6.4.1.3.1) with the time-domain OCC.  Returns
        (bits, metric)."""
        sc0 = cfg01.prb * 12
        l0 = cfg01.start_symbol + 1
        rx = self._on(rx_grid)[l0:l0 + 2 * (cfg01.nof_symbols // 2):2,
                               sc0:sc0 + 12]
        return pucch_mod.format1_detect(rx, cfg01, nof_bits, occ_index)

    def process_srs(self, rx_grid, srs_cfg: csi_mod.SrsConfig):
        """SRS channel snapshot + wideband SNR from the rx grid."""
        return csi_mod.srs_estimate(self._on(rx_grid), srs_cfg)

    def process_ul_slot(self, rx_samples, pid: int = 0, rv: int = 0):
        """(total,) UL samples -> (payload (U, TBS), tb_ok (U,)); updates
        the HARQ pool and the metrics.

        If any UE of this HARQ process holds a soft buffer from a failed
        attempt, the whole-cell buffer is assembled (zeros = no prior
        information for fresh UEs) and soft-combined in the decoder — the
        reference's persistent rx_buffer_pool reservation per (rnti, pid).
        As there, the int8 carries of failed UEs concatenate with float32
        zeros into a float32 buffer (integers, exact in the dematch).
        """
        u_cnt = self.cell.nof_ue
        prevs = [self.harq.get(r, pid).soft_buffer for r in self._rnti_list]
        rx = self._on(rx_samples)
        with l1_tracer.span("ul_slot", slot=self._slot):
            first = next((p for p in prevs if p is not None), None)
            full = None
            if first is not None:
                c, n_cb = first.shape
                full = torch.cat([
                    p if p is not None else torch.zeros(
                        (c, n_cb), dtype=torch.float32, device=self.device)
                    for p in prevs], dim=0)
            payload, tb_ok, nv, cfo, soft = sp.ul_slot(
                rx, self.rntis, self.cell, rv=rv, soft_buffer=full,
                device=self.device)
        # One device -> host copy for the slot's per-UE decisions.
        host = torch.stack([tb_ok.to(torch.float32), nv.to(torch.float32),
                            cfo.to(torch.float32)]).cpu().numpy()
        ok, nv_h, cfo_h = host[0] > 0, host[1], host[2]
        c_per_ue = soft.shape[0] // u_cnt
        ues = []
        for u, rnti in enumerate(self._rnti_list):
            h = self.harq.get(rnti, pid)
            if ok[u]:
                h.reset()
            else:
                h.tx_count += 1
                h.soft_buffer = soft[u * c_per_ue:(u + 1) * c_per_ue]
            nv_u = float(nv_h[u])
            ues.append(UeSlotMetrics(
                rnti=rnti, tb_crc_ok=bool(ok[u]), tbs=self.tbs,
                sinr_db=float(-10.0 * np.log10(max(nv_u, 1e-12))),
                noise_var=nv_u, cfo_hz=float(cfo_h[u]),
                ul_bytes=self.tbs // 8 if ok[u] else 0,
                dl_bytes=self.tbs // 8))
        amp = self._last_amp
        if amp is not None:
            sm = SlotMetrics(slot=self._slot, ues=ues,
                             tx_avg_power=float(amp.avg_power),
                             tx_papr_db=amp.papr_db(),
                             tx_clipped_ratio=float(amp.clipped_ratio))
        else:
            sm = SlotMetrics(slot=self._slot, ues=ues)
        self.metrics.report(sm)
        self._slot += 1
        return payload, tb_ok
