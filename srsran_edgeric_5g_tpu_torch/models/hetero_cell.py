"""Heterogeneous-allocation cell: per-UE PRB spans, modulations and code
rates in one slot.

Port of ``srsran_edgeric_5g_tpu/models/hetero_cell.py``.  The uniform slot
pipeline needs the scheduler's equal-split layout; this is the general path
the reference implements, a per-PDU loop (one PDSCH per codeword, one PUSCH
per PDU).  Per slot the downlink sums every UE's grid before one OFDM
modulation, and the uplink demodulates once and feeds every UE's receiver;
the per-UE loop runs in Python, one UE after the other.  Plans and constant
tensors are built once per allocation set, in ``__init__`` (the reference
compiles one program per layout).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import ofdm
from ..ran.numerology import SlotTiming
from . import pdsch, pusch


class HeteroCellProcessor:
    """DL + UL slot processing for UEs with arbitrary distinct allocations.

    ue_cfgs: PdschConfig per UE (start_prb / nof_prb / modulation /
    target_rate free per UE; the allocations must not overlap).  Runs on
    ``device`` (CUDA by default; a CUDA request without a card raises)."""

    def __init__(self, timing: SlotTiming, ue_cfgs: list[pdsch.PdschConfig],
                 delay_spread_s: float | None = None,
                 device: str | torch.device = "cuda"):
        spans = sorted((c.start_prb, c.start_prb + c.nof_prb) for c in ue_cfgs)
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            if a1 > b0:
                raise ValueError(f"overlapping allocations {(a0, a1)} {(b0, b1)}")
        self.timing = timing
        self.ue_cfgs = list(ue_cfgs)
        self.tbs = [c.derived_tbs() for c in ue_cfgs]
        self.delay_spread_s = delay_spread_s
        self.device = resolve_device(device)
        self.times = np.asarray(timing.cp.data_starts) / timing.srate
        for cfg in self.ue_cfgs:            # plans and constants, once
            pdsch._plans(cfg, 0)
            pdsch.grid_layout(cfg, self.device)
            pdsch.c_init_on(cfg.rnti, cfg.n_id, self.device)

    def _on(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _tx(self, payloads, rvs, fn) -> torch.Tensor:
        """Sum of every UE's grid -> one OFDM modulation: (total,) samples."""
        t = self.timing
        if not len(payloads) == len(self.ue_cfgs) == len(rvs):
            raise ValueError(f"{len(payloads)} payloads, {len(rvs)} rvs for "
                             f"{len(self.ue_cfgs)} UEs")
        grid = None
        for p, cfg, rv in zip(payloads, self.ue_cfgs, rvs):
            g = fn(self._on(p), cfg, t.nsymb, t.nof_subc, rv=rv)
            grid = g if grid is None else grid + g
        return ofdm.modulate_slot(grid, t, scale=1.0 / t.nfft)

    def _rx(self, rx_samples, fn, soft_buffers=None, rvs=None):
        """One OFDM demodulation feeding every UE's receiver."""
        t = self.timing
        rx_grid = ofdm.demodulate_slot(self._on(rx_samples), t, scale=1.0)
        n = len(self.ue_cfgs)
        harq = soft_buffers is not None
        if harq and not len(soft_buffers) == n == len(rvs):
            raise ValueError(f"{len(soft_buffers)} soft buffers, {len(rvs)} rvs "
                             f"for {n} UEs")
        outs = []
        for i, cfg in enumerate(self.ue_cfgs):
            r = fn(rx_grid, cfg, t.srate, self.times,
                   rv=rvs[i] if harq else 0,
                   soft_buffer=self._on(soft_buffers[i]) if harq else None,
                   delay_spread_s=self.delay_spread_s)
            out = (r.payload, r.tb_crc_ok, r.noise_var, r.cfo_hz)
            outs.append(out + (r.soft_buffer,) if harq else out)
        return outs

    def process_dl_slot(self, payloads) -> torch.Tensor:
        """gNB DL TX: [(1, TBS_i)] per-UE payloads -> (total,) samples (the
        true DL conventions: pdsch.process, 0 dB DM-RS EPRE ratio)."""
        return self._tx(payloads, (0,) * len(payloads), pdsch.process)

    def process_dl_rx_slot(self, rx_samples):
        """UE-side DL RX: (total,) samples -> [(payload, tb_ok, nv, cfo)]."""
        return self._rx(rx_samples, pdsch.receive)

    def process_ul_tx_slot(self, payloads) -> torch.Tensor:
        """UE PUSCH TX (3 dB DM-RS boost): [(1, TBS_i)] -> (total,) samples."""
        return self._tx(payloads, (0,) * len(payloads), pusch.transmit)

    def process_ul_slot(self, rx_samples):
        """gNB UL RX: (total,) samples -> [(payload, tb_ok, nv, cfo)]."""
        return self._rx(rx_samples, pusch.process)

    # ------------------------------------------------- HARQ retransmission

    def soft_buffer_shape(self, ue: int) -> tuple[int, int]:
        """(C, N_cb) circular-buffer shape of UE ``ue``'s soft state."""
        seg, rms = pdsch._plans(self.ue_cfgs[ue], 0)
        return (seg.c, rms[0].n_cb)

    def process_dl_rv_slot(self, payloads, rvs: tuple[int, ...]) -> torch.Tensor:
        """gNB DL TX at per-UE redundancy versions (retransmissions)."""
        return self._tx(payloads, tuple(rvs), pdsch.process)

    def process_dl_rx_harq_slot(self, rx_samples, soft_buffers,
                                rvs: tuple[int, ...]):
        """UE-side DL RX with HARQ soft combining; the contract of
        ``process_ul_harq_slot``."""
        return self._rx(rx_samples, pdsch.receive, soft_buffers, tuple(rvs))

    def process_ul_tx_rv_slot(self, payloads, rvs: tuple[int, ...]) -> torch.Tensor:
        """UE PUSCH TX at per-UE redundancy versions (retransmissions)."""
        return self._tx(payloads, tuple(rvs), pusch.transmit)

    def process_ul_harq_slot(self, rx_samples, soft_buffers,
                             rvs: tuple[int, ...]):
        """gNB UL RX with HARQ soft combining.

        ``soft_buffers``: per-UE (C, N_cb) float32 accumulated LLRs (zeros,
        of ``soft_buffer_shape``, for a fresh transmission); ``rvs``: per-UE
        redundancy version of this transmission.  Returns [(payload, tb_ok,
        nv, cfo, new_soft)]: feed ``new_soft`` back on the next
        retransmission."""
        return self._rx(rx_samples, pusch.process, soft_buffers, tuple(rvs))
