"""Full gNB slot pipeline: every per-slot channel of the cell in one DL and
one UL slot-batch call.

Port of ``srsran_edgeric_5g_tpu/parallel/full_cell.py``.

  DL TX (``gnb_dl_slot_batch``):
    * PDSCH for all UEs (the slot pipeline's coding front-end, DM-RS 0 dB);
    * a PDCCH CORESET on symbol 0 with 2 DCIs per UE per DL and special
      slot, all the step's DCIs polar-encoded as one batch;
    * the SS/PBCH block on its occasions (those slots move their PDSCH to
      symbols 6..13), all PBCH payloads polar-encoded as one batch;
    * NZP-CSI-RS rows on their occasions;
    * one OFDM modulation of the merged slot batch, then the TX amplitude
      controller.

  UE UL TX (``ue_ul_slot_batch``): the UE-side generator — PUSCH + PUCCH F1
    HARQ-ACK every UL slot + PUCCH F2 CSI, SRS and PRACH on their occasions.

  UL RX (``gnb_ul_slot_batch``): one OFDM demodulation shared by PUSCH
    (with the int8 HARQ soft carry; the decode runs the CUDA kernel on the
    card), PUCCH F1 detection, PUCCH F2 decode, SRS snapshots and PRACH
    detection.

The slot pattern (``FullCellConfig.tdd_*``, named after srsRAN's
``tdd_ul_dl_cfg``, with the benchmark's frozen reference's meaning and
checks): ``tdd_period`` = 0, the default, is paired spectrum, where every
slot is a DL and a UL slot, and every call runs as it did before the
pattern came.  Otherwise each period of ``tdd_period`` slots starts with
``tdd_dl_slots`` DL slots and ends with ``tdd_ul_slots`` UL slots; the slot
after the DL slots is the special slot when ``tdd_dl_symbols`` > 0, DL on
its first ``tdd_dl_symbols`` symbols.  The special slot carries the PDCCH
and, when its symbol is among those, the CSI-RS, and no PDSCH; any other
slot between the DL and the UL slots carries nothing.  SSB and PDSCH slots
are full DL slots, CSI-RS slots DL or special ones; PUCCH F1 runs on every
UL slot, and the F2, SRS and PRACH occasions are UL slots.  An occasion on
a slot of another kind is refused (``ValueError``, naming the occasion and
the slot) when the configuration is made.

The entry points speak in air slots: a call covers ``S`` consecutive slots
from slot 0, and the slot indices given to sequences and scrambling are
the air slot's own.  ``gnb_dl_slot_batch`` returns all ``S`` slots, zero on
UL slots and after the special slot's DL symbols; ``ue_ul_slot_batch``
takes the UL slots' bits and returns all ``S`` slots, non-zero on UL slots
only; ``gnb_ul_slot_batch`` takes all ``S`` slots and returns results for
the UL slots alone (``S_ul`` rows; F2, SRS and PRACH on their occasions).
A format-0 PRACH preamble longer than a slot (at mu = 1: 110961 samples
against 61440) spans ``prach_span(delay)`` consecutive UL slots from its
occasion's first slot (``prach_occasion_td``), and the gNB reads its window
from those slots joined; an occasion that reaches a slot that is not UL, or
runs past the step, is refused.  The same holds for the ``_mimo`` entry
points.

Under a pattern the slots are selected as views of the slot axis, not
gathers: with ``S`` a multiple of the period, the axis viewed as (S /
period, period, ...) and sliced gives the DL, special and UL slots as
strided views, with no index tensor and no host work per step (the
``_mimo`` UL call flattens its UL slots' antennas into the rows it
demodulates, a copy, as its paired call copies antenna samples that come
non-contiguous).  Only the DL and special slots are modulated and only the
UL slots demodulated; the silent slots are zeros written once into the
step's air slots.  A call refuses (``ValueError``) an ``S`` that is not a
multiple of the period, an SSB period that is not one, and a mesh: TDD
runs on one device.

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

The gNB entry points open ``utils.tracing.l1_tracer`` spans at their stage
boundaries, the same in the SISO and the MIMO pair: ``phy.dl`` around the
DL call with ``phy.dl.code``, ``.control``, ``.grid`` and ``.ofdm``
inside; ``phy.ul`` around the UL call with ``phy.ul.ofdm``, ``.front``,
``.dematch`` and ``.decode`` (the last two in ``slot_pipeline._ul_back``)
and ``.control`` (``.pucch_f1``, ``.pucch_f2``, ``.srs``, ``.prach``).
Under a TDD pattern alone, ``phy.dl.slots`` holds the assembly of the S air
slots from the DL and special slots (the zero fill and the special slot's
cut), and ``phy.ul.slots`` the taking of the UL slots and the PRACH windows
out of them; in paired spectrum neither opens.  Under a torch profiler the
spans are its ranges; with neither the profiler nor the tracer on they cost
a flag check.  Under a pattern each entry point also counts the air slots
of its call by kind in ``utils.tracing.air_slots`` (``dl``, ``special``,
``ul``, ``silent``, ``prach_span``), outside ``STEP_GRAPHS``, so a replay
counts as an eager call does.

On the card each of the four gNB entry points runs its body through
``step_graph.STEP_GRAPHS``: eager at a configuration's first call, then
captured once as a CUDA graph and replayed, inside its ``phy.dl`` /
``phy.ul`` span; eager always under a profiler, on a mesh or on the CPU.
"""

from __future__ import annotations

import dataclasses
import math

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
from .step_graph import STEP_GRAPHS
from ..utils.tracing import air_slots, cached_build, l1_tracer

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


def _slots(cond, s: int) -> np.ndarray:
    """The slots of ``range(s)`` for which ``cond`` holds."""
    return np.asarray([i for i in range(s) if cond(i)], dtype=np.int64)


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
                       s_total: int, out: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Re-interleave the period-k occasion slots (i % k == 0) and their
    complement back to slot order (into ``out`` where it is given)."""
    rest = x_norm.shape[1:]
    nb = s_total // k
    if out is None:
        out = x_norm.new_empty((s_total, *rest))
    out[0::k] = x_occ
    out[:nb * k].view(nb, k, *rest)[:, 1:] = \
        x_norm[:nb * (k - 1)].reshape(nb, k - 1, *rest)
    out[nb * k + 1:] = x_norm[nb * (k - 1):]
    return out


def _dl_special(x: torch.Tensor | None, fc: "FullCellConfig"):
    """(S_pdcch, ...) rows of the DL and special slots in slot order ->
    (the DL slots' rows, the special slots' rows); (x, None) in paired
    spectrum, where every PDCCH slot is a DL slot."""
    if x is None or not fc.tdd_period:
        return x, None
    d = fc.tdd_dl_slots
    if not fc.tdd_dl_symbols:
        return x, x[:0]
    v = x.unflatten(0, (-1, d + 1))
    return v[:, :d].flatten(0, 1), v[:, d]


def _ssb_step(fc: "FullCellConfig") -> int:
    """The SSB period counted in full DL slots (the DL slots of the step in
    order); ``ssb_period`` in paired spectrum."""
    p = fc.tdd_period
    return fc.ssb_period // p * fc.tdd_dl_slots if p else fc.ssb_period


def _dl_grids(g_s: torch.Tensor, g_n: torch.Tensor, k: int, n_dl: int,
              n_sp: int):
    """(the step's DL grids, the special slots' grids or None) from the
    SSB and normal slots' grids: in paired spectrum the ``n_dl`` slots in
    slot order; under a TDD pattern its DL slots in slot order, then its
    ``n_sp`` special slots' grids, zero for the caller's control rows."""
    if n_sp is None:
        return _slot_merge_period(g_s, g_n, k, n_dl), None
    grid = g_n.new_empty((n_dl + n_sp, *g_n.shape[1:]))
    _slot_merge_period(g_s, g_n, k, n_dl, out=grid[:n_dl])
    g_sp = grid[n_dl:]
    g_sp.zero_()
    return grid, g_sp


def _dl_air(td: torch.Tensor, fc: "FullCellConfig", s_total: int) -> torch.Tensor:
    """A TDD step's (S_dl + S_sp, ...) samples, its DL slots then its
    special slots -> (S, ...) samples of its S air slots: the special slots
    cut after their ``tdd_dl_symbols`` DL symbols, every other slot zero.
    Each sample is written once: the slots through strided views of the
    period, the zeros by fills."""
    p, d = fc.tdd_period, fc.tdd_dl_slots
    n_dl = s_total // p * d
    out = td.new_empty((s_total, *td.shape[1:]))
    ov = out.unflatten(0, (s_total // p, p))
    ov[:, :d] = td[:n_dl].unflatten(0, (-1, d))
    n_sp = 1 if fc.tdd_dl_symbols else 0
    if n_sp:
        cut = fc.timing.cp.starts[fc.tdd_dl_symbols]
        ov[:, d, ..., :cut] = td[n_dl:, ..., :cut]
        ov[:, d, ..., cut:] = 0
    ov[:, d + n_sp:] = 0
    return out


def _ul_view(x: torch.Tensor, fc: "FullCellConfig", s_total: int) -> torch.Tensor:
    """The UL slots of a TDD step's (S, ...) air slots: a strided
    (S / period, tdd_ul_slots, ...) view."""
    p, u = fc.tdd_period, fc.tdd_ul_slots
    return x.unflatten(0, (s_total // p, p))[:, p - u:]


def _ul_air(x: torch.Tensor, fc: "FullCellConfig", s_total: int) -> torch.Tensor:
    """(S_ul, ...) samples of the UL slots -> (S, ...) of the S air slots,
    zero on the others; ``x`` itself in paired spectrum."""
    if not fc.tdd_period:
        return x
    p, u = fc.tdd_period, fc.tdd_ul_slots
    out = x.new_empty((s_total, *x.shape[1:]))
    ov = out.unflatten(0, (s_total // p, p))
    ov[:, p - u:] = x.unflatten(0, (-1, u))
    ov[:, :p - u] = 0
    return out


def _prach_windows(rx0: torch.Tensor, fc: "FullCellConfig",
                   s_total: int) -> torch.Tensor:
    """(S_prach, cp + dft) PRACH windows of one antenna's (S, total)
    samples: each occasion's ``prach_span()`` slots joined from its first.
    A view where those slots lie back to back in memory (one antenna's
    samples, or a window of one slot), a copy otherwise."""
    info = fc.prach_info()
    n = info.cp_samples + info.dft_size
    occ = fc.prach_slots(s_total)
    if not len(occ):
        return rx0[:0, :n]
    span, first = fc.prach_span(), int(occ[0])
    rows = rx0[first:first + (len(occ) - 1) * fc.prach_period + span]
    return rows.unfold(0, span, fc.prach_period).transpose(1, 2).flatten(1)[:, :n]


def _ul_take(rx: torch.Tensor, rx0: torch.Tensor, fc: "FullCellConfig",
             s_total: int):
    """(the UL slots of the (S, ...) air samples ``rx``, the PRACH windows
    of one antenna's (S, total) samples ``rx0``); under a TDD pattern inside
    ``phy.ul.slots``, the UL slots as a (S / period, tdd_ul_slots, ...)
    view."""
    if not fc.tdd_period:
        return rx, _prach_windows(rx0, fc, s_total)
    with l1_tracer.span("phy.ul.slots"):
        return _ul_view(rx, fc, s_total), _prach_windows(rx0, fc, s_total)


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
    # TDD slot pattern (srsRAN's tdd_ul_dl_cfg; the module docstring):
    # period 0 = paired spectrum, every slot DL and UL.
    tdd_period: int = 0
    tdd_dl_slots: int = 0
    tdd_dl_symbols: int = 0
    tdd_ul_slots: int = 0
    tdd_ul_symbols: int = 0

    def __post_init__(self):
        p, d, ds = self.tdd_period, self.tdd_dl_slots, self.tdd_dl_symbols
        u, us = self.tdd_ul_slots, self.tdd_ul_symbols
        pattern = (f"TDD pattern period {p}, {d} DL slots + {ds} symbols, "
                   f"{u} UL slots + {us} symbols")
        if p == 0:
            if d or ds or u or us:
                raise ValueError(f"{pattern}: paired spectrum (period 0) "
                                 "takes no other tdd_* field")
            return
        nsymb = self.timing.nsymb
        if not (p > 0 and d >= 1 and u >= 1 and d + u <= p
                and 0 <= ds < nsymb and 0 <= us < nsymb):
            raise ValueError(f"{pattern}: not a pattern (1 <= DL slots, "
                             f"1 <= UL slots, DL + UL slots <= period, "
                             f"symbols 0..{nsymb - 1})")
        if (ds or us) and d + u == p:
            raise ValueError(f"{pattern}: no slot is left for the symbols")
        if d + u + 1 == p and ds + us > nsymb:
            raise ValueError(f"{pattern}: the special slot has {nsymb} symbols")
        # Every occasion of one common period on a slot of its kind.
        s = math.lcm(p, self.ssb_period, max(self.csi_rs_period, 1),
                     self.csi_period, self.srs_period, self.prach_period)
        for occasions in (self.ssb_slots, self.csi_rs_slots, self.csi_slots,
                          self.srs_slots):
            occasions(s)
        self._prach_fits(self._occasions("PRACH", s, self.prach_period,
                                         self.prach_offset, self.ul_slots(s)))

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

    def dl_slots(self, s: int) -> np.ndarray:
        """The full DL slots of a step of ``s`` air slots."""
        p = self.tdd_period
        return _slots(lambda i: not p or i % p < self.tdd_dl_slots, s)

    def special_slots(self, s: int) -> np.ndarray:
        """The special slots: DL on their first ``tdd_dl_symbols`` symbols."""
        p = self.tdd_period
        return _slots(lambda i: p and self.tdd_dl_symbols
                      and i % p == self.tdd_dl_slots, s)

    def ul_slots(self, s: int) -> np.ndarray:
        """The UL slots."""
        p = self.tdd_period
        return _slots(lambda i: not p or i % p >= p - self.tdd_ul_slots, s)

    def _kind(self, i: int) -> str:
        p = self.tdd_period
        if not p:
            return "paired"
        j = i % p
        if j < self.tdd_dl_slots:
            return "DL"
        if j >= p - self.tdd_ul_slots:
            return "UL"
        return ("special" if self.tdd_dl_symbols and j == self.tdd_dl_slots
                else "flexible")

    def _occasions(self, name: str, s: int, period: int, offset: int,
                   allowed: np.ndarray) -> np.ndarray:
        """The slots ``i % period == offset``; each has to be in ``allowed``."""
        occ = _slots(lambda i: i % period == offset, s)
        for i in np.setdiff1d(occ, allowed):
            raise ValueError(f"the {name} occasion at slot {i} falls on a "
                             f"{self._kind(int(i))} slot of the TDD pattern")
        return occ

    def ssb_slots(self, s: int) -> np.ndarray:
        return self._occasions("SSB", s, self.ssb_period, 0, self.dl_slots(s))

    def norm_slots(self, s: int) -> np.ndarray:
        """The full DL slots without SSB: the normal PDSCH slots."""
        return np.setdiff1d(self.dl_slots(s), self.ssb_slots(s))

    def pdcch_slots(self, s: int) -> np.ndarray:
        """The DL and special slots: those with a PDCCH."""
        return np.union1d(self.dl_slots(s), self.special_slots(s))

    def csi_slots(self, s: int) -> np.ndarray:
        return self._occasions("PUCCH F2", s, self.csi_period, self.csi_offset,
                               self.ul_slots(s))

    def srs_slots(self, s: int) -> np.ndarray:
        return self._occasions("SRS", s, self.srs_period, self.srs_offset,
                               self.ul_slots(s))

    def prach_span(self, delay: int = 0) -> int:
        """The slots over which a PRACH occasion delayed by ``delay``
        samples reaches from its first slot."""
        info = self.prach_info()
        return -(-(delay + info.cp_samples + info.dft_size)
                 // self.timing.cp.total)

    def prach_slots(self, s: int, delay: int = 0) -> np.ndarray:
        """The first slots of the PRACH occasions; each occasion, delayed by
        ``delay`` samples, lies on UL slots within the step."""
        occ = self._occasions("PRACH", s, self.prach_period, self.prach_offset,
                              self.ul_slots(s))
        self._prach_fits(occ, delay, s)
        return occ

    def _prach_fits(self, occ: np.ndarray, delay: int = 0,
                    s: int | None = None) -> None:
        """Each occasion from its first slot in ``occ`` reaches UL slots
        only (and no slot past ``s``)."""
        n = self.prach_span(delay)
        for i in occ:
            for j in range(int(i) + 1, int(i) + n):
                if s is not None and j >= s:
                    raise ValueError(f"the PRACH occasion at slot {i} runs "
                                     f"past the step's last slot {s - 1}")
                if self._kind(j) not in ("UL", "paired"):
                    raise ValueError(f"the PRACH occasion at slot {i} runs "
                                     f"onto the {self._kind(j)} slot {j}")

    def csi_rs_slots(self, s: int) -> np.ndarray:
        if self.csi_rs_period <= 0:
            return np.asarray([], dtype=np.int64)
        dl = self.dl_slots(s)
        if self.csi_rs_symbol < self.tdd_dl_symbols:
            dl = np.union1d(dl, self.special_slots(s))
        return self._occasions("CSI-RS", s, self.csi_rs_period,
                               self.csi_rs_offset, dl)

    def _ul_pos(self, slots: np.ndarray, s: int) -> np.ndarray:
        """The rows of UL slots ``slots`` among the step's UL slots."""
        return np.searchsorted(self.ul_slots(s), slots)

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


@cached_build
def _air_slot_kinds(fc: FullCellConfig, s_total: int, direction: str,
                    delay: int = 0) -> tuple:
    """((kind, slots), ...) of a TDD step of ``s_total`` air slots, as
    ``utils.tracing.air_slots`` counts them: down, the DL, special and
    silent slots; up, the UL and silent slots and the slots that the PRACH
    occasions (delayed by ``delay`` samples) span."""
    if direction == "dl":
        n_dl, n_sp = len(fc.dl_slots(s_total)), len(fc.special_slots(s_total))
        return (("dl", n_dl), ("special", n_sp),
                ("silent", s_total - n_dl - n_sp))
    n_ul = len(fc.ul_slots(s_total))
    return (("ul", n_ul), ("silent", s_total - n_ul),
            ("prach_span", len(fc.prach_slots(s_total, delay))
             * fc.prach_span(delay)))


def _tdd_entry(entry: str, fc: FullCellConfig, s_total: int, mesh,
               direction: str, delay: int = 0) -> None:
    """An entry point's call under a TDD pattern: refused on a mesh, for S
    not a multiple of the period, or for an SSB period that is not one of
    the TDD period (the slot views need both); else its air slots counted
    by kind.  Nothing in paired spectrum."""
    p = fc.tdd_period
    if not p:
        return
    if mesh is not None:
        raise ValueError(f"{entry}: the TDD pattern (tdd_period {p}) runs on "
                         "one device; a mesh takes paired spectrum only")
    if s_total % p:
        raise ValueError(f"{entry}: S={s_total} air slots is not a multiple "
                         f"of the TDD period {p}")
    if fc.ssb_period % p:
        raise ValueError(f"{entry}: the SSB period {fc.ssb_period} is not a "
                         f"multiple of the TDD period {p}")
    for kind, n in _air_slot_kinds(fc, s_total, direction, delay):
        air_slots.count(entry, kind, n)


# ============================================================ DL control

@cached_build
def _pdcch_static(fc: FullCellConfig, s_total: int):
    """Static PDCCH mapping: (cfgs, data_sc, dmrs_sc, DM-RS values per PDCCH
    slot, per-DCI scrambling inits, per-DCI RNTI CRC masks)."""
    cfgs = fc.pdcch_cfgs()
    pos = [pdcch_mod._re_positions(c) for c in cfgs]
    data_sc = np.concatenate([p[0] for p in pos])
    if len(np.unique(data_sc)) != len(data_sc):
        raise ValueError("overlapping PDCCH CCEs")
    dmrs_sc = np.unique(np.concatenate([p[1] for p in pos]))
    dmrs_vals = np.stack([
        pdcch_mod._dmrs_values(dataclasses.replace(cfgs[0], slot=sl), dmrs_sc, 0)
        for sl in fc.pdcch_slots(s_total)])                 # (S_pdcch, ndmrs)
    ci = np.asarray([pdcch_mod._scrambling_cinit(c) for c in cfgs], np.int64)
    rnti_mask = np.asarray([[(c.rnti >> (15 - i)) & 1 for i in range(16)]
                            for c in cfgs], np.int8)
    return cfgs, data_sc, dmrs_sc, dmrs_vals, ci, rnti_mask


@cached_build
def _pdcch_tensors(fc: FullCellConfig, s_total: int, device: torch.device):
    _, data_sc, dmrs_sc, dmrs_vals, ci, rnti_mask = _pdcch_static(fc, s_total)
    n = len(dmrs_vals)
    return _dev(data_sc, dmrs_sc, dmrs_vals, np.tile(ci, n),
                np.tile(rnti_mask, (n, 1)), device=device)


def pdcch_rows(dci: torch.Tensor, fc: FullCellConfig,
               s_total: int) -> torch.Tensor:
    """(S_pdcch, NDCI, A) DCI payloads of the DL and special slots ->
    (S_pdcch, nsubc) CORESET symbol rows of those slots (every slot in
    paired spectrum).

    All S_pdcch*NDCI DCIs go through one CRC24C + RNTI mask -> polar -> rate
    match -> scramble -> QPSK chain; the DM-RS values are per-slot host
    constants, at each air slot's own index.
    """
    cfgs = _pdcch_static(fc, s_total)[0]
    data_sc, dmrs_sc, dmrs_vals, ci, mask = _pdcch_tensors(fc, s_total,
                                                           dci.device)
    s, ndci, a = dci.shape
    if s != len(dmrs_vals) or ndci != len(cfgs):
        raise ValueError(f"DCIs {tuple(dci.shape)} for {len(dmrs_vals)} PDCCH "
                         f"slots of S={s_total}, {len(cfgs)} DCIs per slot")
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


@cached_build
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


@cached_build
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


@cached_build
def _csi_rs_rows_np(fc: FullCellConfig, s_total: int) -> np.ndarray:
    """(S_pdcch, nsubc) NZP-CSI-RS contribution of each DL and special
    slot's csi_rs_symbol (zeros off-occasion)."""
    slots = fc.pdcch_slots(s_total)
    rows = np.zeros((len(slots), fc.timing.nof_subc), np.complex64)
    for sl in fc.csi_rs_slots(s_total):
        c = fc.csi_rs_cfg(int(sl))
        rows[np.searchsorted(slots, sl), csi_rs.csi_rs_subcarriers(c)] = \
            csi_rs.csi_rs_pilots(c)
    return rows


@cached_build
def _csi_rs_rows(fc: FullCellConfig, s_total: int, device: torch.device):
    return _dev(_csi_rs_rows_np(fc, s_total), device=device)[0]


@cached_build
def _rntis(fc: FullCellConfig, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(fc.rntis(), device=device)


def gnb_dl_slot_batch(pay_norm, pay_ssb, dci, pbch, fc: FullCellConfig,
                      s_total: int, device: str | torch.device = "cuda",
                      mesh=None) -> torch.Tensor:
    """Full DL slot batch -> (S, total) complex64 baseband samples of the S
    air slots (zero on UL slots and after the special slot's DL symbols).

    pay_norm: (S_norm, U, TBS_dl) PDSCH payloads of the full DL slots
    without SSB; pay_ssb: (S_ssb, U, TBS_dl_ssb) payloads of the SSB slots
    (shorter PDSCH); dci: (S_pdcch, 2U, A) DCI payloads of the DL and
    special slots; pbch: (S_ssb, 24) MIB payloads.
    On a mesh the PDSCH coding runs sharded (``slot_pipeline._dl_code``);
    the control channels, grids and samples are replicated.
    """
    _tdd_entry("gnb_dl_slot_batch", fc, s_total, mesh, "dl")
    with l1_tracer.span("phy.dl"):
        return STEP_GRAPHS(
            "gnb_dl_slot_batch",
            lambda *x: _dl_slot_batch(*x, fc, s_total, device, mesh),
            (pay_norm, pay_ssb, dci, pbch), device, mesh, fc=fc, s_total=s_total)


def _dl_slot_batch(pay_norm, pay_ssb, dci, pbch, fc: FullCellConfig, s_total: int,
                   device, mesh) -> torch.Tensor:
    """``gnb_dl_slot_batch``'s body, eager."""
    dev = resolve_device(device)
    pay_norm, pay_ssb = sp._on(pay_norm, dev), sp._on(pay_ssb, dev)
    dci, pbch = (sp.unshard(sp._on(x, dev)) for x in (dci, pbch))
    cell_n, cell_s = fc.dl_cell(), fc.dl_cell_ssb()
    t = cell_n.timing
    norm_idx, ssb_idx = fc.norm_slots(s_total), fc.ssb_slots(s_total)
    if ssb_idx[0] != 0:
        raise ValueError("the SSB occasions must start at slot 0")
    rntis = _rntis(fc, dev)
    u, k = fc.nof_ue, _ssb_step(fc)

    with l1_tracer.span("phy.dl.code"):
        syms_n = sp.unshard(sp._dl_code(pay_norm, rntis, cell_n, mesh=mesh)
                            ).reshape(len(norm_idx), u, -1)
        syms_s = sp.unshard(sp._dl_code(pay_ssb, rntis, cell_s, mesh=mesh)
                            ).reshape(len(ssb_idx), u, -1)
    with l1_tracer.span("phy.dl.control"):
        prows = pdcch_rows(dci, fc, s_total)                # (S_pdcch, nsubc)
        blocks = ssb_blocks(pbch, fc, s_total)              # (S_ssb, 4, 240)
        crows = (_csi_rs_rows(fc, s_total, dev) if fc.csi_rs_period > 0
                 else None)

    with l1_tracer.span("phy.dl.grid"):
        prows, prows_sp = _dl_special(prows, fc)            # DL, special slots
        crows, crows_sp = _dl_special(crows, fc)
        rows_n = {0: _slot_drop_period(prows, k)}
        rows_s = {0: prows[0::k]}
        if crows is not None:
            rows_n[fc.csi_rs_symbol] = _slot_drop_period(crows, k)
            rows_s[fc.csi_rs_symbol] = crows[0::k]
        sc0 = fc.ssb_first_subcarrier
        for j in range(4):
            row = torch.zeros((len(ssb_idx), t.nof_subc),
                              dtype=torch.complex64, device=dev)
            row[:, sc0:sc0 + 240] = blocks[:, j]
            rows_s[2 + j] = rows_s[2 + j] + row if 2 + j in rows_s else row
        g_n = sp._dl_grid(syms_n, cell_n, dmrs_scale=1.0, add_rows=rows_n)
        g_s = sp._dl_grid(syms_s, cell_s, dmrs_scale=1.0, add_rows=rows_s)
        grid, g_sp = _dl_grids(g_s, g_n, k, len(prows),
                               None if prows_sp is None else len(prows_sp))
        if g_sp is not None:            # the special slots: PDCCH, CSI-RS
            g_sp[:, 0] = prows_sp
            if crows_sp is not None:
                g_sp[:, fc.csi_rs_symbol] += crows_sp
    with l1_tracer.span("phy.dl.ofdm"):
        td = _tx_amplitude(ofdm.modulate_slot(grid, t, scale=1.0 / t.nfft), fc)
    if fc.tdd_period:
        with l1_tracer.span("phy.dl.slots"):
            td = _dl_air(td, fc, s_total)
    return sp.shard(td, mesh, ())


def _tx_amplitude(td: torch.Tensor, fc: FullCellConfig) -> torch.Tensor:
    """The TX amplitude controller every transmit passes through."""
    if fc.tx_ceiling > 0:
        return amplitude.clip(td, fc.tx_gain, fc.tx_ceiling)[0]
    return amplitude.scale(td, fc.tx_gain)[0]


# ============================================================ PUCCH

@cached_build
def _f1_static(fc: FullCellConfig, s_total: int):
    """PUCCH F1 low-PAPR sequences per (UL slot, symbol) + OCC row: one UE
    per PRB with initial_cs 0 and occ 0, so the values are UE-independent."""
    cfg0 = pucch_mod.Pucch01Config(n_id=fc.n_id, slot=0, start_symbol=0,
                                   nof_symbols=14, initial_cs=0)
    ndata = 7
    ul = fc.ul_slots(s_total)
    data_seq = np.empty((len(ul), ndata, 12), np.complex64)
    dmrs_seq = np.empty((len(ul), ndata, 12), np.complex64)
    for i, sl in enumerate(ul):
        c = dataclasses.replace(cfg0, slot=int(sl))
        for m in range(ndata):
            data_seq[i, m] = pucch_mod._f0_sequence(c, 0, 2 * m + 1)
            dmrs_seq[i, m] = pucch_mod._f0_sequence(c, 0, 2 * m)
    return data_seq, dmrs_seq, pucch_mod._occ(ndata, 0)


@cached_build
def _f1_tensors(fc: FullCellConfig, s_total: int, device: torch.device):
    return _dev(*_f1_static(fc, s_total), device=device)


def _f1_symbols(ack: torch.Tensor, fc: FullCellConfig,
                s_total: int) -> torch.Tensor:
    """(S_ul, U, 2) ACK bits of the UL slots -> (S_ul, 14, 12U) PUCCH F1 REs
    (QPSK data on odd symbols, DM-RS on even; UE u on PRB u)."""
    data_seq, dmrs_seq, w = _f1_tensors(fc, s_total, ack.device)
    s, u, _ = ack.shape
    b = ack.to(torch.float32)
    d = torch.complex(1.0 - 2.0 * b[..., 0], 1.0 - 2.0 * b[..., 1]) / SQRT2
    data = d[:, :, None, None] * w[None, None, :, None] * data_seq[:, None]
    dmrs = (w[None, None, :, None] * dmrs_seq[:, None]).expand(data.shape)
    rows = torch.stack([dmrs, data], dim=3)                 # (S, U, 7, 2, 12)
    return rows.reshape(s, u, 14, 12).transpose(1, 2).reshape(s, 14, u * 12)


def _f1_detect(rx_grid: torch.Tensor, fc: FullCellConfig, s_total: int):
    """(S_ul, nsymb, nsubc) grids of the UL slots -> ((S_ul, U, 2) ACK bits,
    (S_ul, U) |metric|): the DM-RS despread estimates each occasion's
    channel, the data despread is derotated by it."""
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


@cached_build
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


@cached_build
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

@cached_build
def _srs_static(fc: FullCellConfig):
    seqs = np.stack([csi_rs.srs_sequence(fc.srs_cfg(u))
                     for u in range(fc.nof_ue)])            # (U, m_sc)
    scs = np.stack([csi_rs.srs_subcarriers(fc.srs_cfg(u))
                    for u in range(fc.nof_ue)])             # (U, m_sc)
    row = np.zeros((fc.timing.nof_subc,), np.complex64)
    row[scs.reshape(-1)] = seqs.reshape(-1)
    return seqs, scs, row


@cached_build
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

def _prach_detect_batch(rx_freq: torch.Tensor, fc: FullCellConfig):
    """(B, L_RA) frequency-domain occasions -> ((B, 64) metric, delay,
    detected) at the cell's PRACH configuration and threshold."""
    return prach_mod.detect_batch(rx_freq, fc.prach_cfg(), fc.prach_threshold)


def prach_occasion_td(fc: FullCellConfig, preamble_index: int,
                      delay: int = 24, amplitude: float = 1.0) -> np.ndarray:
    """Static time-domain PRACH occasion, delayed and padded to whole slots:
    the UE-side transmit, (``fc.prach_span(delay)``, total) samples of the
    consecutive slots that it reaches from its first, with a raised-cosine
    edge taper over half the CP on each side (a rectangular window leaks
    across the 15 kHz grid)."""
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
    out = np.zeros(fc.prach_span(delay) * total, np.complex64)
    out[delay:delay + len(td)] = td
    return out.reshape(-1, total)


def _add_prach(td: torch.Tensor, fc: FullCellConfig, s_total: int,
               preamble: int, delay: int, amplitude: float) -> None:
    """Add the PRACH occasion into the (S, ...) air samples ``td`` (on the
    first port where there is a port axis), from each occasion's first
    slot onward."""
    occ = fc.prach_slots(s_total, delay)
    ptd = torch.as_tensor(prach_occasion_td(fc, preamble, delay, amplitude),
                          device=td.device)
    for j, row in enumerate(ptd):
        sel = _slot_slice(occ + j)
        if td.dim() == 2:
            td[sel] += row
        else:
            td[sel, 0] += row


# ============================================================ UE UL TX

def _ue_ul_control(ack: torch.Tensor, csi: torch.Tensor, fc: FullCellConfig,
                   s_total: int) -> torch.Tensor:
    """(S_ul, nsymb, nsubc) UE control contribution of the UL slots: PUCCH
    F1 on every one, F2 CSI and SRS on their occasions."""
    dev = ack.device
    t = fc.timing
    u = fc.nof_ue
    extra = torch.zeros((ack.shape[0], t.nsymb, t.nof_subc),
                        dtype=torch.complex64, device=dev)
    extra[:, :14, :u * 12] = _f1_symbols(ack, fc, s_total)
    extra[_slot_slice(fc._ul_pos(fc.csi_slots(s_total), s_total)), 0:2] += \
        _f2_symbols(csi, fc, s_total)
    extra[_slot_slice(fc._ul_pos(fc.srs_slots(s_total), s_total)), 13] += \
        _srs_tensors(fc, dev)[2]
    return extra


def ue_ul_slot_batch(payloads, ack, csi, fc: FullCellConfig, s_total: int,
                     prach_preamble: int = 7, prach_delay: int = 24,
                     prach_amplitude: float = 0.002,
                     device: str | torch.device = "cuda",
                     mesh=None) -> torch.Tensor:
    """UE-side UL generator: (S_ul, U, TBS_ul) PUSCH payloads + (S_ul, U, 2)
    ACK bits of the UL slots + (S_csi, U, K) CSI bits -> (S, total) clean
    samples of the S air slots, with PUSCH + PUCCH F1 (+ F2 / SRS / PRACH
    on their occasions) on the UL slots and zero elsewhere.  The PRACH
    preamble arrives ``prach_amplitude`` under the PUSCH RMS (open-loop
    power control targets the detector, not the PUSCH level), delayed by
    ``prach_delay`` samples.
    On a mesh the PUSCH coding runs sharded; the samples are replicated."""
    _tdd_entry("ue_ul_slot_batch", fc, s_total, mesh, "ul", prach_delay)
    cell = fc.ul_cell()
    sp._check_siso(cell)
    dev = resolve_device(device)
    payloads = sp._on(payloads, dev)
    ack, csi = (sp.unshard(sp._on(x, dev)) for x in (ack, csi))
    t = cell.timing
    s, u, _ = payloads.shape
    syms = sp.unshard(sp._dl_code(payloads, _rntis(fc, dev), cell, mesh=mesh)
                      ).reshape(s, u, -1)
    grid = sp._dl_grid(syms, cell)                # PUSCH DM-RS boost sqrt(2)
    td = ofdm.modulate_slot(grid + _ue_ul_control(ack, csi, fc, s_total), t,
                            scale=1.0 / t.nfft)
    td = _ul_air(td, fc, s_total)
    _add_prach(td, fc, s_total, prach_preamble, prach_delay, prach_amplitude)
    return sp.shard(td, mesh, ())


def ue_ul_slot_batch_mimo(payloads, ack, csi, fc: FullCellConfig, s_total: int,
                          prach_preamble: int = 7, prach_delay: int = 24,
                          prach_amplitude: float = 0.002,
                          device: str | torch.device = "cuda",
                          mesh=None) -> torch.Tensor:
    """UE-side MIMO UL generator: (S_ul, U, TBS_L) PUSCH payloads (+ ACK /
    CSI) -> (S, L, total) per-port samples of the S air slots, as
    ``ue_ul_slot_batch``.  PUSCH layers on all ports; PUCCH F1/F2, SRS and
    the PRACH occasion on port 0.  On a mesh as ``ue_ul_slot_batch``."""
    _tdd_entry("ue_ul_slot_batch_mimo", fc, s_total, mesh, "ul", prach_delay)
    dev = resolve_device(device)
    ack, csi = (sp.unshard(sp._on(x, dev)) for x in (ack, csi))
    td = sp.unshard(sp.dl_slot_batch_mimo(
        payloads, _rntis(fc, dev), fc.ul_cell(),
        extra_rows=_ue_ul_control(ack, csi, fc, s_total), device=dev,
        mesh=mesh))                                            # (S_ul, L, total)
    td = _ul_air(td, fc, s_total)
    _add_prach(td, fc, s_total, prach_preamble, prach_delay, prach_amplitude)
    return sp.shard(td, mesh, ())


# ============================================================ gNB UL RX

def _ul_results(payload, tb_ok, nv, cfo, soft, rx_grid0, win,
                fc: FullCellConfig, s_total: int, soft_flat: bool,
                mesh) -> dict:
    """The UL result dict: the PUSCH outputs (on a mesh laid out as
    ``slot_pipeline.ul_slot_batch``'s, the flat carry over the codeblock
    axes), and the single-port control channels detected on one antenna's
    grids of the UL slots ``rx_grid0`` (S_ul, nsymb, nsubc) and PRACH
    windows ``win`` (S_prach, cp + dft; ``_prach_windows``), replicated."""
    s, u = rx_grid0.shape[0], fc.nof_ue
    seg, rm = sp._plans(fc.ul_cell(), 0)
    with l1_tracer.span("phy.ul.control"):
        with l1_tracer.span("phy.ul.control.pucch_f1"):
            ack_bits, ack_metric = _f1_detect(rx_grid0, fc, s_total)
        with l1_tracer.span("phy.ul.control.pucch_f2"):
            csi_bits, csi_ok = _f2_decode(
                _slot_take(rx_grid0, fc._ul_pos(fc.csi_slots(s_total), s_total)),
                fc, s_total)
        with l1_tracer.span("phy.ul.control.srs"):
            srs_h, srs_snr = _srs_estimate(
                _slot_take(rx_grid0, fc._ul_pos(fc.srs_slots(s_total), s_total)),
                fc)
        with l1_tracer.span("phy.ul.control.prach"):
            rx_freq = prach_mod.ofdm_demodulate_prach(win, fc.prach_info())
            pr_metric, pr_delay, pr_det = _prach_detect_batch(rx_freq, fc)
    rows = sp.ROWS
    control = {
        "ack_bits": ack_bits, "ack_metric": ack_metric,
        "csi_bits": csi_bits, "csi_ok": csi_ok,
        "srs_h": srs_h, "srs_snr_db": srs_snr,
        "prach_metric": pr_metric, "prach_delay": pr_delay,
        "prach_detected": pr_det,
    }
    return {
        "payload": sp.shard(payload, mesh, rows, (s, u, payload.shape[-1])),
        "tb_ok": sp.shard(tb_ok, mesh, rows, (s, u)),
        "noise_var": sp.shard(nv, mesh, rows, (s, u)),
        "cfo": sp.shard(cfo, mesh, rows, (s, u)),
        "soft": sp.shard(soft, mesh, sp.CODEBLOCKS,
                         None if soft_flat else (s, u * seg.c, rm.n_cb)),
        **{k: sp.shard(v, mesh, ()) for k, v in control.items()},
    }


def gnb_ul_slot_batch(rx, fc: FullCellConfig, s_total: int,
                      soft_in=None, new_data=None,
                      num_iters: int = decoder.DEFAULT_ITERS,
                      soft_flat: bool = False, early_stop: bool = True,
                      device: str | torch.device = "cuda", mesh=None) -> dict:
    """Full UL slot batch: (S, total) samples of the S air slots -> every
    UL channel's results on the UL slots.

    Returns a dict: payload (S_ul, U, TBS), tb_ok (S_ul, U), noise_var,
    cfo, soft (S_ul, U*C, n_cb) HARQ state, ack_bits (S_ul, U, 2),
    ack_metric (S_ul, U), csi_bits (S_csi, U, K), csi_ok (S_csi, U), srs_h
    (S_srs, U, m_sc), srs_snr_db (S_srs, U), prach_metric / delay /
    detected (S_prach, 64).

    ``soft_flat``: take and return the HARQ state in the decoder's flat
    (S_ul*U*C, n_cb) layout, as a caller does that feeds it straight back.
    ``new_data``: (S_ul, U) mask, 1 = new transmission (its buffer is
    zeroed).

    On a mesh every rank demodulates the whole batch (the control channels
    are replicated); the PUSCH front, dematch and decode run on the rank's
    rows and codeblocks.  ``soft_in`` may be the sharded carry of the
    previous call.
    """
    _tdd_entry("gnb_ul_slot_batch", fc, s_total, mesh, "ul")
    with l1_tracer.span("phy.ul"):
        return STEP_GRAPHS(
            "gnb_ul_slot_batch",
            lambda *x: _ul_slot_batch(*x, fc, s_total, num_iters, soft_flat, early_stop,
                                      device, mesh),
            (rx, soft_in, new_data), device, mesh, fc=fc, s_total=s_total,
            num_iters=num_iters, soft_flat=soft_flat, early_stop=early_stop)


def _ul_slot_batch(rx, soft_in, new_data, fc: FullCellConfig, s_total: int,
                   num_iters: int, soft_flat: bool, early_stop: bool, device,
                   mesh) -> dict:
    """``gnb_ul_slot_batch``'s body, eager."""
    cell = fc.ul_cell()
    sp._check_siso(cell)
    dev = resolve_device(device)
    rx = sp.unshard(sp._on(rx, dev))
    t = cell.timing
    rx_ul, win = _ul_take(rx, rx, fc, s_total)
    with l1_tracer.span("phy.ul.ofdm"):
        rx_grid = ofdm.demodulate_slot(rx_ul, t, scale=1.0).reshape(
            -1, t.nsymb, t.nof_subc)                            # (S_ul, nsymb, nsubc)
    with l1_tracer.span("phy.ul.front"):
        llr, nv, cfo = sp._ul_front(None, _rntis(fc, dev), cell,
                                    rx_grid=rx_grid, mesh=mesh)
    payload, tb_ok, soft = sp._ul_back(llr, cell, 0, num_iters,
                                       sp._on(soft_in, dev),
                                       sp._on(new_data, dev),
                                       early_stop=early_stop, mesh=mesh)
    return _ul_results(payload, tb_ok, nv, cfo, soft, rx_grid, win, fc,
                       s_total, soft_flat, mesh)


# ============================================================ MIMO variants

def _dl_control_rows(dci: torch.Tensor, fc: FullCellConfig,
                     s_total: int) -> torch.Tensor:
    """(S_pdcch, nsymb, nsubc) port-0 control contribution of the DL and
    special slots: PDCCH on symbol 0 of each, NZP-CSI-RS on its occasions
    (the SSB blocks are added onto the SSB sub-batch by the caller)."""
    t = fc.timing
    extra = torch.zeros((dci.shape[0], t.nsymb, t.nof_subc),
                        dtype=torch.complex64, device=dci.device)
    extra[:, 0] += pdcch_rows(dci, fc, s_total)
    extra[:, fc.csi_rs_symbol] += _csi_rs_rows(fc, s_total, dci.device)
    return extra


def gnb_dl_slot_batch_mimo(pay_norm, pay_ssb, dci, pbch, fc: FullCellConfig,
                           s_total: int, device: str | torch.device = "cuda",
                           mesh=None) -> torch.Tensor:
    """Full MIMO DL slot batch -> (S, L, total) per-port samples of the S
    air slots; payloads at the L-layer TBS of ``dl_cell_mimo`` /
    ``dl_cell_ssb_mimo``, the rest as ``gnb_dl_slot_batch``.  The
    sub-batches' grids are merged and modulated once.  On a mesh as
    ``gnb_dl_slot_batch``."""
    _tdd_entry("gnb_dl_slot_batch_mimo", fc, s_total, mesh, "dl")
    with l1_tracer.span("phy.dl"):
        return STEP_GRAPHS(
            "gnb_dl_slot_batch_mimo",
            lambda *x: _dl_slot_batch_mimo(*x, fc, s_total, device, mesh),
            (pay_norm, pay_ssb, dci, pbch), device, mesh, fc=fc, s_total=s_total)


def _dl_slot_batch_mimo(pay_norm, pay_ssb, dci, pbch, fc: FullCellConfig, s_total: int,
                        device, mesh) -> torch.Tensor:
    """``gnb_dl_slot_batch_mimo``'s body, eager."""
    dev = resolve_device(device)
    dci, pbch = (sp.unshard(sp._on(x, dev)) for x in (dci, pbch))
    cell_n, cell_s = fc.dl_cell_mimo(), fc.dl_cell_ssb_mimo()
    if fc.ssb_slots(s_total)[0] != 0:
        raise ValueError("the SSB occasions must start at slot 0")
    k = _ssb_step(fc)
    rntis = _rntis(fc, dev)
    with l1_tracer.span("phy.dl.control"):
        extra = _dl_control_rows(dci, fc, s_total)
        blocks = ssb_blocks(pbch, fc, s_total)
    with l1_tracer.span("phy.dl.grid"):
        extra, ex_sp = _dl_special(extra, fc)               # DL, special slots
        sc0 = fc.ssb_first_subcarrier
        ex_s = extra[0::k].clone()
        ex_s[:, 2:6, sc0:sc0 + 240] += blocks
        ex_n = _slot_drop_period(extra, k)
    # dl_slot_batch_mimo opens phy.dl.code and phy.dl.grid itself.
    g_n = sp.unshard(sp.dl_slot_batch_mimo(
        pay_norm, rntis, cell_n, extra_rows=ex_n, return_grid=True,
        device=dev, mesh=mesh))
    g_s = sp.unshard(sp.dl_slot_batch_mimo(
        pay_ssb, rntis, cell_s, extra_rows=ex_s, return_grid=True,
        device=dev, mesh=mesh))
    with l1_tracer.span("phy.dl.grid"):
        grid, g_sp = _dl_grids(g_s, g_n, k, len(extra),
                               None if ex_sp is None else len(ex_sp))
        if g_sp is not None:            # the special slots: control on port 0
            g_sp[:, 0] = ex_sp
    t = fc.timing
    with l1_tracer.span("phy.dl.ofdm"):
        td = _tx_amplitude(ofdm.modulate_slot(grid, t, scale=1.0 / t.nfft), fc)
    if fc.tdd_period:
        with l1_tracer.span("phy.dl.slots"):
            td = _dl_air(td, fc, s_total)
    return sp.shard(td, mesh, ())


def gnb_ul_slot_batch_mimo(rx, fc: FullCellConfig, s_total: int,
                           soft_in=None, new_data=None,
                           num_iters: int = decoder.DEFAULT_ITERS,
                           soft_flat: bool = False, early_stop: bool = True,
                           device: str | torch.device = "cuda",
                           mesh=None) -> dict:
    """Full MIMO UL slot batch: (S, P, total) antenna samples of the S air
    slots -> the result dict of ``gnb_ul_slot_batch`` (payload at the
    L-layer TBS).  The UL slots of all antennas are demodulated once; PUSCH
    takes the LxP front, PUCCH F1/F2, SRS and PRACH antenna 0.  On a mesh
    as ``gnb_ul_slot_batch``."""
    _tdd_entry("gnb_ul_slot_batch_mimo", fc, s_total, mesh, "ul")
    with l1_tracer.span("phy.ul"):
        return STEP_GRAPHS(
            "gnb_ul_slot_batch_mimo",
            lambda *x: _ul_slot_batch_mimo(*x, fc, s_total, num_iters, soft_flat,
                                           early_stop, device, mesh),
            (rx, soft_in, new_data), device, mesh, fc=fc, s_total=s_total,
            num_iters=num_iters, soft_flat=soft_flat, early_stop=early_stop)


def _ul_slot_batch_mimo(rx, soft_in, new_data, fc: FullCellConfig, s_total: int,
                        num_iters: int, soft_flat: bool, early_stop: bool, device,
                        mesh) -> dict:
    """``gnb_ul_slot_batch_mimo``'s body, eager."""
    cell = fc.ul_cell()
    dev = resolve_device(device)
    rx = sp.unshard(sp._on(rx, dev))
    t = cell.timing
    p_rx = rx.shape[1]
    rx_ul, win = _ul_take(rx, rx[:, 0], fc, s_total)
    with l1_tracer.span("phy.ul.ofdm"):
        rx_grid = ofdm.demodulate_slot(rx_ul.reshape(-1, rx.shape[-1]), t,
                                       scale=1.0).reshape(-1, p_rx, t.nsymb, t.nof_subc)
    with l1_tracer.span("phy.ul.front"):
        llr, nv, cfo = sp._ul_front_mimo(None, _rntis(fc, dev), cell,
                                         rx_grid=rx_grid, mesh=mesh)
    payload, tb_ok, soft = sp._ul_back(llr, cell, 0, num_iters,
                                       sp._on(soft_in, dev),
                                       sp._on(new_data, dev),
                                       early_stop=early_stop, mesh=mesh)
    return _ul_results(payload, tb_ok, nv, cfo, soft, rx_grid[:, 0],
                       win, fc, s_total, soft_flat, mesh)
