"""Cell slot pipeline, data plane: multi-UE DL encode + UL decode.

Port of ``srsran_edgeric_5g_tpu/parallel/slot_pipeline.py`` (the SISO,
multi-cell and multi-layer programs).  One call processes a batch of slots
for all UEs of a cell, or of several same-config carriers.  UE allocations
are uniform-width and contiguous from a static first PRB, so every per-UE
gather/scatter is a slice + reshape.

DL: segment -> LDPC encode -> rate match -> scramble -> modulate (two CUDA
kernels on the card, ``ops.pdsch_code``) -> place subgrids -> OFDM
modulate.  UL: OFDM demod -> DM-RS estimate -> MMSE
equalize -> demap -> wire quantise -> descramble (one CUDA kernel on the
card, ``ops.pusch_front``, into int8 wire LLRs) -> rate dematch (+ HARQ
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

Sharding (``mesh=``, a ``DeviceMesh`` of ``mesh.py``; the reference's
``with_sharding_constraint`` specs, laid out as ``DTensor`` blocks):
  * TB rows (S*U, .)          -> P('ue')
  * codeblock rows (S*U*C, .) -> P(('ue', 'cb'))
  * resource grid / samples   -> replicated (the symbol rows are gathered)
Each stage computes on the rank's block of rows with the same ops as
without a mesh; K1 decodes the rank's codeblocks, its early stop over the
whole batch (an all-reduce over the codeblock axes per round).  Multi-cell puts the
carriers on the mesh's leading 'cell' (or 'host') axis: rows over
('cell', 'ue'), codeblocks over ('cell', 'ue', 'cb'), samples over 'cell',
and nothing crosses that axis.  The inputs are global tensors (the same on
every rank) or DTensors; the outputs are DTensors (``unshard`` or
``.full_tensor()`` gives the global tensor) with every rank's result equal
to the one without a mesh.

The entry points (``dl_slot``, ``dl_slot_batch``, ``ul_slot``,
``ul_slot_batch``, the multi-cell pair and the ``*_mimo`` pair) take
``device`` ("cuda" by default; the rank's device on a mesh) and move their
inputs there; a CUDA request on a host without a CUDA device raises.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import host_constant, resolve_device
from ..ops import channel_est, equalizer, modulation, ofdm, pdsch_code, pusch_front
from ..ops import dmrs as dmrs_mod
from ..ops.ldpc import decoder, rate_match, segmenter
from ..ran.numerology import N_SC_PER_PRB, SlotTiming, slot_timing
from ..ran.tbs import nof_re, tbs as tbs_calc
from .mesh import (CB_AXIS, CELL_AXIS, HOST_AXIS, UE_AXIS, coordinate,
                   is_dtensor, row_block, spec_axes, take, wrap)

from ..utils.tracing import cached_build, l1_tracer

ROWS = (UE_AXIS,)                    # the reference's row_axes default
CODEBLOCKS = ((UE_AXIS, CB_AXIS),)   # and cb_axes default


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


@cached_build
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


@cached_build
def _dmrs_full_band(cell: CellConfig, device: torch.device) -> torch.Tensor:
    """(ndmrs, npilots_fullband) pilot sequences shared by all UEs."""
    rows = []
    for l in cell.dmrs_symbols:
        ci = torch.tensor([dmrs_mod.dmrs_c_init(cell.slot, l, cell.n_id)],
                          dtype=torch.int64, device=device)
        rows.append(dmrs_mod.dmrs_sequence(ci, 6 * cell.nof_prb)[0])
    return torch.stack(rows)


def shard(x, mesh, spec, shape=None):
    """``x`` laid out as ``P(*spec)`` on ``mesh`` (the reference's
    ``with_sharding_constraint``): a DTensor of ``shape`` (a row-major
    reshape of ``x``, default its shape) whose leading dim is split over
    the spec's axes.  ``x`` is a global tensor (each rank keeps its block;
    nothing moves) or a DTensor (gathered where its blocks do not hold the
    new ones).  Without a mesh, ``x`` reshaped."""
    shape = tuple(x.shape) if shape is None else tuple(shape)
    if mesh is None:
        return x.reshape(shape)
    axes = spec_axes(mesh, spec)
    local = take(x, mesh, lambda c: row_block(shape[0], mesh, axes, c), shape,
                 into=axes)
    return wrap(local, mesh, axes, shape)


def unshard(x):
    """The global tensor of ``x``: a DTensor all-gathered over its sharded
    axes (counted in ``mesh.COLLECTIVES``; the counterpart of the
    reference's ``multihost_utils.process_allgather``), anything else as
    it is."""
    if not is_dtensor(x):
        return x
    return take(x, x.device_mesh, lambda c: (0, x.shape[0]))


def _axes(mesh, spec) -> tuple[str, ...]:
    return () if mesh is None else spec_axes(mesh, spec)


def _covering(block: tuple[int, int], unit: int) -> tuple[int, int]:
    """The rows of ``unit`` sub-rows each that hold sub-rows [lo, hi)."""
    lo, hi = block
    return (lo // unit, -(-hi // unit)) if hi > lo else (lo // unit, lo // unit)


def _share(n: int, unit: int, mesh, axes):
    """A split over ``axes`` of the n*unit sub-rows of n rows (a TB's
    codeblocks, a slot's UE rows): ``rows`` (coord -> the rows that hold a
    rank's sub-rows), this rank's first such row, and its sub-rows as a
    slice of those rows' sub-rows."""
    rows = lambda crd: _covering(row_block(n * unit, mesh, axes, crd), unit)
    me = coordinate(mesh)
    (lo, hi), first = row_block(n * unit, mesh, axes, me), rows(me)[0]
    return rows, first, slice(lo - first * unit, hi - first * unit)


def _on(x, dev: torch.device):
    """An input on ``dev``: a DTensor stays as it is (its blocks are on the
    mesh's devices), None stays None."""
    if x is None or is_dtensor(x):
        return x
    return torch.as_tensor(x, device=dev)


def _carrier_specs(mesh):
    """(samples, TB rows, codeblock rows) specs of the multi-carrier
    programs: the carriers on the mesh's leading axis, 'cell' or 'host'."""
    lead = CELL_AXIS if mesh is None else mesh.mesh_dim_names[0]
    if lead not in (CELL_AXIS, HOST_AXIS):
        raise ValueError(f"the carriers lie on a leading '{CELL_AXIS}' or "
                         f"'{HOST_AXIS}' axis, not '{lead}'")
    return (lead,), ((lead, UE_AXIS),), ((lead, UE_AXIS, CB_AXIS),)


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


def _dl_code(payloads, rntis: torch.Tensor | None, cell: CellConfig,
             rv: int = 0, ci: torch.Tensor | None = None, mesh=None,
             row_axes=ROWS, cb_axes=CODEBLOCKS):
    """Coding front-end for a (..., TBS) batch of B_tb TBs -> (B_tb, G/Qm)
    symbols: all codeblocks of all TBs go through segment -> encode -> rate
    match (``pdsch_code.encode``), then every TB row through scramble ->
    modulate (``pdsch_code.modulate``), each one CUDA kernel on the card and
    the plain chain on the CPU.  ``ci`` (B_tb,) replaces the per-row
    scrambling inits derived from ``rntis`` (which may then be None).

    On a mesh the rank codes its block of codeblocks (over ``cb_axes``) from
    the TBs that hold them, gathers the bits of its block of TB rows (over
    ``row_axes``) and returns the symbols as a DTensor of those rows."""
    seg, rm = _plans(cell, rv)
    c, tbs = seg.c, payloads.shape[-1]
    b_tb = math.prod(payloads.shape[:-1])
    rows, cbx = _axes(mesh, row_axes), _axes(mesh, cb_axes)
    cb_tbs, _, own = _share(b_tb, c, mesh, cbx)
    tb_rows = lambda crd: row_block(b_tb, mesh, rows, crd)
    bits = pdsch_code.encode(take(payloads, mesh, cb_tbs, (b_tb, tbs), cbx),
                             seg, rm, own)                    # (block, E)
    bits = wrap(bits, mesh, cbx, (b_tb * c, rm.e))
    bits = take(bits, mesh, tb_rows, (b_tb, c * rm.e), rows)  # (rows, G)
    if ci is None:
        ci = _scrambling_inits(rntis, cell, b_tb // cell.nof_ue)
    r0, r1 = tb_rows(coordinate(mesh))
    syms = pdsch_code.modulate(bits, ci[r0:r1], cell.modulation)  # (rows, G/Qm)
    return wrap(syms, mesh, rows, (b_tb, syms.shape[-1]))


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
    grid[..., host_constant(cell.data_symbols, dev), band0:band0 + span] = band
    p0 = 6 * cell.first_prb
    pil = _dmrs_full_band(cell, dev)[:, p0:p0 + span // 2]
    grid[..., host_constant(cell.dmrs_symbols, dev), band0:band0 + span:2] = (
        pil * float(np.float32(dmrs_scale)))
    for l, row in (add_rows or {}).items():
        grid[..., l, :] += row.to(torch.complex64)
    return grid


def _dl_grid_ofdm(syms: torch.Tensor, cell: CellConfig) -> torch.Tensor:
    """(..., U, G/Qm) modulated symbols -> (..., total) time-domain samples."""
    t = cell.timing
    return ofdm.modulate_slot(_dl_grid(syms, cell), t, scale=1.0 / t.nfft)


def _dl_samples(payloads, rntis, cell: CellConfig, rv: int, device,
                mesh) -> torch.Tensor:
    """(..., U, TBS) payloads -> (S, total) samples, global on every rank:
    the symbol rows are gathered, and every rank builds the grids and runs
    the OFDM modulation."""
    _check_siso(cell)
    dev = resolve_device(device)
    syms = unshard(_dl_code(_on(payloads, dev), unshard(_on(rntis, dev)),
                            cell, rv, mesh=mesh))
    return _dl_grid_ofdm(syms.reshape(-1, cell.nof_ue, syms.shape[-1]), cell)


def dl_slot(payloads, rntis, cell: CellConfig, rv: int = 0,
            device: str | torch.device = "cuda", mesh=None) -> torch.Tensor:
    """DL direction: (U, TBS) payload bits -> (total,) baseband samples.
    UE u occupies PRBs [first_prb + u*prb_per_ue, ...)."""
    return shard(_dl_samples(payloads, rntis, cell, rv, device, mesh)[0],
                 mesh, ())


def dl_slot_batch(payloads, rntis, cell: CellConfig, rv: int = 0,
                  device: str | torch.device = "cuda",
                  mesh=None) -> torch.Tensor:
    """Slot-batched DL: (S, U, TBS) payload bits + (U,) RNTIs -> (S, total)
    complex64 samples.  The coding front-end runs as ONE flat (S*U) batch;
    grid assembly and OFDM are batched over slots."""
    return shard(_dl_samples(payloads, rntis, cell, rv, device, mesh), mesh, ())


def _ul_slots(rx_samples, rntis, cell: CellConfig, rv: int, num_iters: int,
              soft_buffer, new_data, device, mesh, batch: bool):
    """The SISO UL of ``ul_slot_batch`` (``batch``: per-UE outputs (S, U,
    ...)) and ``ul_slot`` (U, ...)."""
    _check_siso(cell)
    dev = resolve_device(device)
    seg, rm = _plans(cell, rv)
    rx_samples = _on(rx_samples, dev)
    lead = (rx_samples.shape[0], cell.nof_ue) if batch else (cell.nof_ue,)
    llr, nv, cfo = _ul_front(rx_samples, unshard(_on(rntis, dev)), cell,
                             mesh=mesh)
    payload, tb_ok, soft = _ul_back(llr, cell, rv, num_iters,
                                    _on(soft_buffer, dev), _on(new_data, dev),
                                    mesh=mesh)
    soft_shape = (*lead[:-1], lead[-1] * seg.c, rm.n_cb)
    return (shard(payload, mesh, ROWS, (*lead, payload.shape[-1])),
            shard(tb_ok, mesh, ROWS, lead), shard(nv, mesh, ROWS, lead),
            shard(cfo, mesh, ROWS, lead),
            shard(soft, mesh, CODEBLOCKS, soft_shape))


def ul_slot_batch(rx_samples, rntis, cell: CellConfig, rv: int = 0,
                  num_iters: int = decoder.DEFAULT_ITERS,
                  soft_buffer=None, new_data=None,
                  device: str | torch.device = "cuda", mesh=None):
    """Slot-batched UL: (S, total) samples -> (payload (S, U, TBS) int8,
    tb_ok (S, U), noise_var (S, U), cfo (S, U), soft (S, U*C, n_cb) int8).

    ``soft`` is the HARQ circular buffer per codeblock; feed it back as
    ``soft_buffer`` with the retransmission's ``rv`` for chase/IR
    combining.  ``new_data``: (S, U) float mask, 1 = first transmission of
    that TB (its soft buffer is zeroed before combining).  The front-end
    and the dematch/decode back-end run as one flat (S*U) TB batch.
    """
    return _ul_slots(rx_samples, rntis, cell, rv, num_iters, soft_buffer,
                     new_data, device, mesh, True)


def ul_slot(rx_samples, rntis, cell: CellConfig, rv: int = 0,
            num_iters: int = decoder.DEFAULT_ITERS, soft_buffer=None,
            device: str | torch.device = "cuda", mesh=None):
    """UL direction: (total,) samples -> decoded (U, TBS), (U,) crc_ok,
    (U,) noise_var, (U,) cfo, (U*C, n_cb) HARQ soft buffer."""
    return _ul_slots(rx_samples, rntis, cell, rv, num_iters, soft_buffer,
                     None, device, mesh, False)


def _ul_front(rx_samples, rntis: torch.Tensor | None, cell: CellConfig,
              rx_grid=None, ci: torch.Tensor | None = None, mesh=None,
              row_axes=ROWS):
    """OFDM demod -> chest -> MMSE -> demap -> wire quantise -> descramble:
    (S, total) samples (any (..., total) batch of S slots) -> ((S, U, G)
    int8 wire LLRs, (S, U) noise_var, (S, U) cfo).  The chest runs here;
    the per-RE chain after it is ``pusch_front.demap``.  ``rx_grid`` (S,
    nsymb, nsubc) skips the OFDM demodulation when the caller already
    demodulated the slots (the full cell shares one grid between PUSCH,
    PUCCH and SRS).
    ``ci`` (S*U,) replaces the per-row descrambling inits derived from
    ``rntis`` (multi-cell flattens the carriers into the S dim).

    On a mesh the rank demodulates the slots that hold its block of the
    S*U rows (over ``row_axes``) and returns that block of the flat rows:
    DTensors (S*U, G), (S*U,), (S*U,)."""
    t = cell.timing
    u, w = cell.nof_ue, cell.ue_width_sc
    span = u * w
    band0 = cell.first_prb * N_SC_PER_PRB
    rows = _axes(mesh, row_axes)
    n_slots = (rx_grid.shape[0] if rx_grid is not None
               else math.prod(rx_samples.shape[:-1]))
    slots, s0, own = _share(n_slots, u, mesh, rows)

    if rx_grid is None:
        rx_grid = ofdm.demodulate_slot(
            take(rx_samples, mesh, slots, (n_slots, t.cp.total), rows), t,
            scale=1.0)
    else:
        rx_grid = take(rx_grid, mesh, slots, into=rows)
    s = rx_grid.shape[0]                                      # the rank's slots
    dev = rx_grid.device
    band = rx_grid[..., band0:band0 + span]                   # (S, nsymb, span)

    pilots = _dmrs_full_band(cell, dev)
    pat = dmrs_mod.dmrs_pattern(1, cell.prb_per_ue, port=0)
    span_pat = dmrs_mod.dmrs_pattern(1, u * cell.prb_per_ue, port=0)
    times = np.asarray([t.cp.data_starts[l] for l in cell.dmrs_symbols]) / t.srate
    npil_ue = len(pat.subcarriers)
    ndmrs = len(cell.dmrs_symbols)
    if not (span_pat.subcarriers == np.arange(0, u * w, 2)).all():
        raise ValueError("pipeline assumes type-1 port-0 DM-RS (even subcarriers)")

    rx_p = band[:, host_constant(cell.dmrs_symbols, dev), 0::2]  # (S, ndmrs, span/2)
    rx_p = rx_p.reshape(s, ndmrs, u, npil_ue).permute(0, 2, 1, 3)
    rx_p = rx_p.reshape(s * u, ndmrs, npil_ue)
    # Undo the TS 38.214 3 dB DM-RS boost on the RX pilots: the LS
    # estimate's conj-product convention needs unit-amplitude references.
    rx_p = rx_p * float(np.float32(1.0 / np.sqrt(2.0)))
    p0 = 6 * cell.first_prb
    ref_p = pilots[:, p0:p0 + len(span_pat.subcarriers)]
    ref_p = ref_p.reshape(ndmrs, u, npil_ue).permute(1, 0, 2).repeat(s, 1, 1)

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
    rot = None
    if ndmrs > 1:
        t_data = host_constant(
            np.asarray([t.cp.data_starts[l] for l in cell.data_symbols],
                       np.float32) / np.float32(t.srate), dev)
        ph = float(np.float32(-2.0 * np.pi)) * cfo[:, None] * t_data
        rot = torch.complex(torch.cos(ph), torch.sin(ph))     # (S*U, ndata)
    if ci is None:
        ci = _scrambling_inits(rntis, cell, n_slots)
    # The reference's int8 wire domain: pairs with the decoder's 'wire_auto'
    # schedule.
    llr = pusch_front.demap(rx_grid, cell.data_symbols, band0, u, h, nv, rot,
                            ci[s0 * u:(s0 + s) * u], cell.modulation)
    llr, nv, cfo = llr[own], nv[own], cfo[own]
    if mesh is None:
        return llr.reshape(s, u, llr.shape[-1]), nv.reshape(s, u), cfo.reshape(s, u)
    n = n_slots * u
    return (wrap(llr, mesh, rows, (n, llr.shape[-1])), wrap(nv, mesh, rows, (n,)),
            wrap(cfo, mesh, rows, (n,)))


def _decoder_input(llr: torch.Tensor, cell: CellConfig, rv: int = 0,
                   soft_buffer: torch.Tensor | None = None,
                   new_data: torch.Tensor | None = None) -> torch.Tensor:
    """Rate dematch (+ HARQ combine) of a flat (B_tb, G) wire-LLR batch ->
    (B_tb*C, cols*Zc) int8 decoder input.  A new transmission
    (``new_data`` 1) zeroes its soft buffer before combining."""
    seg, rm = _plans(cell, rv)
    keep = None if new_data is None else (1.0 - new_data).repeat_interleave(seg.c)
    return _dematch(llr.reshape(-1, rm.e), cell, rv, soft_buffer, keep)


def _dematch(cb_llr: torch.Tensor, cell: CellConfig, rv: int,
             soft_buffer: torch.Tensor | None,
             keep: torch.Tensor | None) -> torch.Tensor:
    """(n, E) wire LLRs of n codeblocks (+ their (n, n_cb) HARQ buffers,
    each kept where ``keep`` is 1) -> (n, cols*Zc) int8 decoder input.

    Wire-domain combine: every LLR is an integer (demap clip ±20 -> ±120)
    and the combined buffer saturates at ±127 — the reference's saturated
    LLR sum — so the dematch runs in bf16 (integers <= 247 are exact) and
    the result is exactly int8."""
    _, rm = _plans(cell, rv)
    if soft_buffer is not None and keep is not None:
        soft_buffer = soft_buffer * keep.to(soft_buffer.dtype)[:, None]
    full = rate_match.rate_dematch(cb_llr, rm, soft_buffer,
                                   dtype=torch.bfloat16, saturate=True)
    return full.to(torch.int8)


def _ul_back(llr, cell: CellConfig, rv: int = 0,
             num_iters: int = decoder.DEFAULT_ITERS,
             soft_buffer=None, new_data=None, early_stop: bool = True,
             mesh=None, row_axes=ROWS, cb_axes=CODEBLOCKS):
    """Rate dematch (+ HARQ soft combine) + LDPC decode + TB CRC for a
    (..., G) batch of B_tb TBs' LLRs -> (payload (B_tb, TBS), tb_ok (B_tb,),
    new_soft (B_tb*C, n_cb)), new_soft the int8 circular buffers (the
    per-HARQ-process rx_buffer state of the reference).  ``soft_buffer``
    (any reshape of (B_tb*C, n_cb)) is the carry to combine with;
    ``new_data`` (B_tb TBs) zeroes it where 1.

    On a mesh the rank dematches and decodes its block of the B_tb*C
    codeblocks (over ``cb_axes``; K1 on the card) with the early stop over
    every rank's block (all-reduced over the ``cb_axes`` groups), then
    gathers the hard bits of its block of TB rows (over ``row_axes``) for
    the TB CRC.  The
    outputs are DTensors of those blocks; the carry may come in as one."""
    seg, rm = _plans(cell, rv)
    c, g = seg.c, llr.shape[-1]
    b_tb = math.prod(llr.shape[:-1])
    rows, cbx = _axes(mesh, row_axes), _axes(mesh, cb_axes)
    cb_block = lambda crd: row_block(b_tb * c, mesh, cbx, crd)
    cb_tbs, _, own = _share(b_tb, c, mesh, cbx)
    with l1_tracer.span("phy.ul.dematch"):
        cb_llr = take(llr, mesh, cb_tbs, (b_tb, g), cbx).reshape(-1, rm.e)[own]
        sb = (None if soft_buffer is None else
              take(soft_buffer, mesh, cb_block, (b_tb * c, rm.n_cb), cbx))
        keep = (None if new_data is None else
                (1.0 - take(new_data, mesh, cb_tbs, (b_tb,), cbx)
                 ).repeat_interleave(c)[own])
        full = _dematch(cb_llr, cell, rv, sb, keep)
        new_soft = full[:, 2 * seg.zc:2 * seg.zc + rm.n_cb]
    # The early stop's batch is the global one (the reference's while_loop
    # over the sharded batch): every rank sharing the codeblock axes.
    groups = None if mesh is None else [mesh.get_group(a) for a in cbx]
    with l1_tracer.span("phy.ul.decode"):
        hard, _ = decoder.decode(full, seg.bg, seg.zc, num_iters=num_iters,
                                 early_stop=early_stop, schedule="wire_auto",
                                 process_groups=groups)
        k = hard.shape[-1]
        hard = take(wrap(hard, mesh, cbx, (b_tb * c, k)), mesh,
                    lambda crd: row_block(b_tb, mesh, rows, crd), (b_tb, c * k),
                    rows)
        payload, tb_ok = segmenter.desegment_tb(hard.reshape(-1, k), seg)
    return (wrap(payload, mesh, rows, (b_tb, payload.shape[-1])),
            wrap(tb_ok, mesh, rows, (b_tb,)),
            wrap(new_soft, mesh, cbx, (b_tb * c, rm.n_cb)))


# ================================================================= multi-cell

def multi_cell_dl_slot_batch(payloads, rntis, cell: CellConfig, rv: int = 0,
                             device: str | torch.device = "cuda",
                             mesh=None) -> torch.Tensor:
    """Multi-carrier DL: (NC, S, U, TBS) payloads + (NC, U) RNTIs ->
    (NC, S, total) complex64 samples.

    The carriers are independent cells of one configuration (the reference
    runs one PHY instance per sector), so they flatten into the slot batch:
    the coding front-end runs as one (NC*S*U) TB batch, grid + OFDM over
    NC*S slots.  On a mesh the carriers lie on its leading axis ('cell' or
    'host'): rows over it and 'ue', codeblocks over it, 'ue' and 'cb', and
    each rank modulates its block of carriers (no data crosses that axis)."""
    _check_siso(cell)
    dev = resolve_device(device)
    payloads = _on(payloads, dev)
    rntis = unshard(_on(rntis, dev))
    nc, s, u, tbs = payloads.shape
    carriers, row_axes, cb_axes = _carrier_specs(mesh)
    syms = _dl_code(payloads, None, cell, rv, ci=_cell_ci(rntis, cell, nc, s),
                    mesh=mesh, row_axes=row_axes, cb_axes=cb_axes)
    cax = _axes(mesh, carriers)
    syms = take(syms, mesh, lambda crd: row_block(nc, mesh, cax, crd),
                (nc, s * u, syms.shape[-1]), cax)
    td = _dl_grid_ofdm(syms.reshape(-1, u, syms.shape[-1]), cell)
    return wrap(td.reshape(syms.shape[0], s, -1), mesh, cax, (nc, s, td.shape[-1]))


def multi_cell_ul_slot_batch(rx_samples, rntis, cell: CellConfig, rv: int = 0,
                             num_iters: int = decoder.DEFAULT_ITERS,
                             device: str | torch.device = "cuda", mesh=None):
    """Multi-carrier UL: (NC, S, total) samples + (NC, U) RNTIs ->
    (payload (NC, S, U, TBS), tb_ok, noise_var, cfo (NC, S, U),
    soft (NC, S, U*C, n_cb)).  The carriers flatten into the slot batch:
    one front-end over NC*S slots and one early-stop decode over all
    NC*S*U*C codeblocks; on a mesh as ``multi_cell_dl_slot_batch``, every
    output over the carrier axis."""
    _check_siso(cell)
    dev = resolve_device(device)
    rx_samples = _on(rx_samples, dev)
    rntis = unshard(_on(rntis, dev))
    nc, s, _ = rx_samples.shape
    u = cell.nof_ue
    seg, rm = _plans(cell, rv)
    carriers, row_axes, cb_axes = _carrier_specs(mesh)
    llr, nv, cfo = _ul_front(rx_samples, None, cell,
                             ci=_cell_ci(rntis, cell, nc, s), mesh=mesh,
                             row_axes=row_axes)
    payload, tb_ok, soft = _ul_back(llr, cell, rv, num_iters, mesh=mesh,
                                    row_axes=row_axes, cb_axes=cb_axes)
    lead = (nc, s, u)
    return (shard(payload, mesh, carriers, (*lead, payload.shape[-1])),
            shard(tb_ok, mesh, carriers, lead), shard(nv, mesh, carriers, lead),
            shard(cfo, mesh, carriers, lead),
            shard(soft, mesh, carriers, (nc, s, u * seg.c, rm.n_cb)))


# ================================================================ multi-layer

def _span_dmrs(cell: CellConfig, port: int):
    """Static span-wide DM-RS geometry of one port: (span subcarrier offsets,
    frequency OCC per pilot, per-UE pilot-pair centres)."""
    span_pat = dmrs_mod.dmrs_pattern(1, cell.nof_ue * cell.prb_per_ue, port=port)
    pat = dmrs_mod.dmrs_pattern(1, cell.prb_per_ue, port=port)
    centers = (pat.subcarriers[0::2] + pat.subcarriers[1::2]) // 2
    return span_pat.subcarriers, np.asarray(span_pat.wf), centers


@cached_build
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
                       device: str | torch.device = "cuda",
                       mesh=None) -> torch.Tensor:
    """Multi-layer DL (or UE TX): (S, U, TBS_L) payloads -> (S, L, total)
    per-port samples, or with ``return_grid`` the (S, L, nsymb, nsubc)
    grids (a caller that merges grids modulates once).

    ``extra_rows``: optional (S, nsymb, nsubc) contribution added to port 0
    (control channels sent single-port on REs disjoint from the data band).
    DM-RS rides at data amplitude.  On a mesh the coding runs sharded as in
    ``dl_slot_batch`` and the grids are built on every rank.
    """
    dev = resolve_device(device)
    payloads = _on(payloads, dev)
    rntis = unshard(_on(rntis, dev))
    extra_rows = unshard(_on(extra_rows, dev))
    n_l = cell.n_layers
    t = cell.timing
    s, u, tbs = payloads.shape
    w = cell.ue_width_sc
    span = u * w
    band0 = cell.first_prb * N_SC_PER_PRB
    ndata = len(cell.data_symbols)

    with l1_tracer.span("phy.dl.code"):
        syms = unshard(_dl_code(payloads, rntis, cell, rv, mesh=mesh))
    with l1_tracer.span("phy.dl.grid"):
        # d(L*i + l) -> layer l: (S, U, ndata, w, L) -> (S, L, ndata, U*w).
        m5 = syms.reshape(s, u, ndata, w, n_l).to(torch.complex64)
        band = m5.permute(0, 4, 2, 1, 3).reshape(s, n_l, ndata, span)
        grid = torch.zeros((s, n_l, t.nsymb, t.nof_subc), dtype=torch.complex64,
                           device=dev)
        grid[:, :, host_constant(cell.data_symbols, dev),
             band0:band0 + span] = band
        grid[:, :, host_constant(cell.dmrs_symbols, dev)] = \
            _dmrs_rows_mimo(cell, dev)
        if extra_rows is not None:
            grid[:, 0] += extra_rows.to(torch.complex64)
    if not return_grid:
        with l1_tracer.span("phy.dl.ofdm"):
            grid = ofdm.modulate_slot(grid, t, scale=1.0 / t.nfft)
    return shard(grid, mesh, ())


def ul_slot_batch_mimo(rx_samples, rntis, cell: CellConfig, rv: int = 0,
                       num_iters: int = decoder.DEFAULT_ITERS,
                       soft_buffer=None, new_data=None, early_stop: bool = True,
                       device: str | torch.device = "cuda", mesh=None):
    """Multi-antenna UL: (S, P, total) samples -> (payload (S, U, TBS_L),
    tb_ok (S, U), noise_var (S, U), cfo (S, U), soft (S, U*C, n_cb)), with
    the HARQ contract and the mesh layout of ``ul_slot_batch``."""
    dev = resolve_device(device)
    rx_samples = _on(rx_samples, dev)
    s, u = rx_samples.shape[0], cell.nof_ue
    seg, rm = _plans(cell, rv)
    llr, nv, cfo = _ul_front_mimo(rx_samples, unshard(_on(rntis, dev)), cell,
                                  mesh=mesh)
    payload, tb_ok, soft = _ul_back(llr, cell, rv, num_iters,
                                    _on(soft_buffer, dev), _on(new_data, dev),
                                    early_stop=early_stop, mesh=mesh)
    return (shard(payload, mesh, ROWS, (s, u, payload.shape[-1])),
            shard(tb_ok, mesh, ROWS, (s, u)), shard(nv, mesh, ROWS, (s, u)),
            shard(cfo, mesh, ROWS, (s, u)),
            shard(soft, mesh, CODEBLOCKS, (s, u * seg.c, rm.n_cb)))


def _ul_front_mimo(rx_samples, rntis: torch.Tensor, cell: CellConfig,
                   rx_grid=None, mesh=None, row_axes=ROWS):
    """Multi-antenna UL front: (S, P, total) samples, or a demodulated
    (S, P, nsymb, nsubc) ``rx_grid`` -> ((S*U, L*G) int8 wire LLRs, (S, U)
    noise_var, (S, U) cfo); on a mesh the rank's block of the S*U rows (over
    ``row_axes``, from the slots that hold it), as DTensors (S*U, L*G),
    (S*U,), (S*U,).

    Per (antenna, CDM group) the pilots are OCC-despread, (u ± v)/2 over
    pilot pairs, into half-rate virtual pilots for ``estimate_port``; the
    CFO is the angle of the correlations summed over streams and antennas;
    the LxP MMSE weights are computed once per subcarrier and applied to
    every data symbol by ``pusch_front.demap``, which demaps, quantises and
    descrambles them; the layer axis stays minor, so expanding it by Qm is
    the layer interleave."""
    n_l = cell.n_layers
    t = cell.timing
    u, w = cell.nof_ue, cell.ue_width_sc
    span = u * w
    band0 = cell.first_prb * N_SC_PER_PRB
    ndata = len(cell.data_symbols)
    ndmrs = len(cell.dmrs_symbols)

    rows = _axes(mesh, row_axes)
    n_slots = (rx_samples if rx_grid is None else rx_grid).shape[0]
    slots, _, own = _share(n_slots, u, mesh, rows)
    if rx_grid is None:
        rx_samples = take(rx_samples, mesh, slots, into=rows)
        s, p_rx, total = rx_samples.shape
        rx_grid = ofdm.demodulate_slot(rx_samples.reshape(s * p_rx, total), t,
                                       scale=1.0)
        rx_grid = rx_grid.reshape(s, p_rx, t.nsymb, t.nof_subc)
    else:
        rx_grid = take(rx_grid, mesh, slots, into=rows)
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
        rx_p = band[:, :, host_constant(cell.dmrs_symbols, dev), grp::2]  # (S, P, ndmrs, npil)
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

    # The pilots were derotated by their symbol times; each data symbol
    # still carries e^{j2pi*cfo*t_l} (float32 phase, as the reference).
    rot = None
    if ndmrs > 1:
        t_data = host_constant(
            np.asarray([t.cp.data_starts[l] for l in cell.data_symbols],
                       np.float32) / np.float32(t.srate), dev)
        ph = float(np.float32(-2.0 * np.pi)) * cfo[:, None, :] \
            * t_data[None, :, None]                            # (S, n, U)
        rot = torch.complex(torch.cos(ph), torch.sin(ph)).transpose(1, 2).reshape(
            s * u, ndata)
    # Noise floor: a zero estimate (noiseless loopback) would blow the
    # whitening up into all-zero equaliser outputs, whose all-zero codeword
    # passes parity.
    nv_p = torch.clamp(nv[..., None], min=1e-9)               # (S, P, U, 1)
    wts, nv_out = equalizer.mmse_weights_grid(h, nv_p)
    llr = pusch_front.demap(rx_grid, cell.data_symbols, band0, u, wts, nv_out, rot,
                            _scrambling_inits(rntis, cell, s), cell.modulation)
    nv = torch.mean(nv, dim=1)
    if mesh is None:
        return llr, nv, cfo
    n = n_slots * u
    return (wrap(llr[own], mesh, rows, (n, llr.shape[-1])),
            wrap(nv.reshape(-1)[own], mesh, rows, (n,)),
            wrap(cfo.reshape(-1)[own], mesh, rows, (n,)))
