"""Layered min-sum LDPC decoders: the CUDA kernel and its plain twins.

Port of the two Pallas TPU kernels of ``srsran_edgeric_5g_tpu/ops/ldpc/
decoder_pallas.py``: K1 ``decode_pallas`` and K2 ``decode_pallas_int8``.
The kernel is ``csrc/ldpc_layered.cu`` (one CTA per codeblock, Zc lanes on
the thread axis, the posterior in shared memory; its header says what
bounds it).  ``decode_layered`` (K1) has two modes:

  * f32 (``wire=False``): ``decode_pallas``'s normalised min-sum
    (α = 0.8, hard bits ``post < 0``), which ``decode(schedule="pallas")``
    computes;
  * wire (``wire=True``): the reference's ``layered_wire`` semantics on int8
    wire-domain input, which the main path's ``decode(schedule="wire_auto")``
    computes.

``decode_int8`` (K2) is ``decode_pallas_int8``: int8 input, int16
posterior, int8 messages, 13/16 normalisation, with its tile early exit
(a tile of ``b_tile`` codeblocks stops once all of them meet parity).

Each wrapper launches the kernel for a CUDA tensor and raises if it cannot;
for a CPU tensor it runs its ``*_plain`` twin, the same function in plain
PyTorch, which the CPU tests and the on-card comparison use.
``decode_layered``'s early stop is per codeblock in both (the JAX wire
schedule stops per batch; on every input measured the two rules give the
same bits, see ROADMAP.md Queue C).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import cuda_build
from .decoder import (DEFAULT_ITERS, DEFAULT_SCALING, _plan_tensors,
                      check_parity, get_decode_plan, hard_decision, init_state,
                      sweep)
from .graph import get_graph

KERNEL = "ldpc_layered"         # K1's launch counter (and the library)
KERNEL_INT8 = "ldpc_int8"       # K2's launch counter
MODE_F32, MODE_WIRE, MODE_INT8 = 0, 1, 2   # the kernel's template modes
INT8_CLAMP = 120  # decoder_pallas.LLR_CLAMP: K2's message clip
MIN_ZC = 64      # decoder_pallas.MIN_ZC: the kernel's lifting-size floor
MAX_ZC = 384     # largest NR lifting size (one thread per lane)
MAX_DEG = 19     # kMaxDeg in csrc/ldpc_layered.cu


def cuda_supported(zc: int) -> bool:
    return MIN_ZC <= zc <= MAX_ZC


def _check_input(llrs: torch.Tensor, bg: int, zc: int, wire: bool) -> None:
    g = get_graph(bg, zc)
    want = torch.int8 if wire else torch.float32
    if llrs.dtype != want:
        raise TypeError(f"{'wire' if wire else 'f32'} mode takes {want} LLRs, "
                        f"got {llrs.dtype}")
    if llrs.ndim != 2 or llrs.shape[1] != g.n_full:
        raise ValueError(f"LLRs must be (B, {g.n_full}) for BG{bg} Zc={zc}, "
                         f"got {tuple(llrs.shape)}")


def decode_layered(llrs: torch.Tensor, bg: int, zc: int,
                   num_iters: int = DEFAULT_ITERS,
                   scaling: float = DEFAULT_SCALING,
                   wire: bool = False, early_stop: bool = False):
    """Decode (B, cols*Zc) LLRs -> (hard (B, kb*Zc) int8, ok (B,) bool,
    sweeps (B,) int32 run per codeblock).

    ``wire=True`` takes int8 wire-domain LLRs, ``wire=False`` float32.  A
    CUDA tensor runs the kernel (or raises); a CPU tensor runs the plain
    version."""
    _check_input(llrs, bg, zc, wire)
    if llrs.device.type == "cpu":
        return decode_layered_plain(llrs, bg, zc, num_iters, scaling, wire,
                                    early_stop)
    out = _launch(llrs, MODE_WIRE if wire else MODE_F32, bg, zc, num_iters,
                  scaling, early_stop)
    cuda_build.LAUNCHES[KERNEL] += 1
    return out


def _check_cuda(llrs: torch.Tensor, bg: int, zc: int) -> None:
    if llrs.device.type != "cuda":
        raise ValueError(f"no {KERNEL} kernel for device {llrs.device}")
    if not cuda_supported(zc):
        raise ValueError(f"{KERNEL} takes {MIN_ZC} <= Zc <= {MAX_ZC}, got {zc}")
    if not llrs.is_contiguous():
        raise ValueError("LLRs must be contiguous")
    if get_graph(bg, zc).max_row_degree() > MAX_DEG:
        raise ValueError(f"row degree {get_graph(bg, zc).max_row_degree()} > "
                         f"{MAX_DEG}")


def _launch(llrs, mode, bg, zc, num_iters, scaling, early_stop, b_tile=1):
    """Run the kernel on a CUDA tensor: the fused path (all sweeps in one
    launch, per-codeblock exit), or for K2 with ``early_stop`` and
    ``b_tile`` > 1 the tiled path (one launch per sweep, per-tile exit).
    Returns (hard, ok, sweeps)."""
    _check_cuda(llrs, bg, zc)
    g = get_graph(bg, zc)
    dev = llrs.device
    b = llrs.shape[0]
    row_start, edge_col, edge_shift = _edge_tables(bg, zc, dev)
    tables = (row_start.data_ptr(), edge_col.data_ptr(), edge_shift.data_ptr())
    hard = torch.empty((b, g.kb * zc), dtype=torch.int8, device=dev)
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    sweeps = torch.empty((b,), dtype=torch.int32, device=dev)
    shape = (b, g.rows, g.cols, g.kb, g.num_edges, zc, num_iters)
    scale = (float(np.float32(scaling)), int(scaling * 65536))
    lib = _library()
    tiled = mode == MODE_INT8 and early_stop and b_tile > 1 and num_iters > 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tiled:
            l_state = torch.empty((b, g.cols * zc), dtype=torch.int16, device=dev)
            r_state = torch.empty((b, g.num_edges, zc), dtype=torch.int8,
                                  device=dev)
            viol = torch.zeros((num_iters, b // b_tile), dtype=torch.int32,
                               device=dev)
            rc = lib.ldpc_int8_decode_tiled(
                llrs.data_ptr(), l_state.data_ptr(), r_state.data_ptr(),
                viol.data_ptr(), hard.data_ptr(), ok.data_ptr(),
                sweeps.data_ptr(), *tables, *shape, b_tile, stream)
        else:
            r_scratch = (torch.empty((b, g.num_edges, zc), dtype=torch.float32,
                                     device=dev) if mode == MODE_F32 else None)
            rc = lib.ldpc_layered_decode(
                llrs.data_ptr(), mode, hard.data_ptr(), ok.data_ptr(),
                sweeps.data_ptr(),
                0 if r_scratch is None else r_scratch.data_ptr(), *tables,
                *shape, *scale, int(early_stop), stream)
    if rc != 0:
        smem = lib.ldpc_layered_smem_bytes(mode, g.rows, g.cols, g.num_edges,
                                           zc)
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {rc} (mode "
                           f"{mode}, BG{bg} Zc={zc}, {smem} B shared memory "
                           f"per block{', tiled' if tiled else ''})")
    return hard, ok, sweeps


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    lib.ldpc_layered_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.ldpc_layered_smem_bytes.restype = ctypes.c_size_t
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ldpc_layered_decode.argtypes = (
        [ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        + [i32] * 7 + [ctypes.c_float, i32, i32, ptr])
    lib.ldpc_layered_decode.restype = ctypes.c_int
    lib.ldpc_int8_decode_tiled.argtypes = [ptr] * 10 + [i32] * 8 + [ptr]
    lib.ldpc_int8_decode_tiled.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _edge_tables(bg: int, zc: int, device: torch.device):
    """(row_start (rows+1,), edge_col (E,), edge_shift (E,)) int32 on device;
    edges row-major, columns ascending within a row."""
    g = get_graph(bg, zc)
    row_start = np.concatenate([[0], np.cumsum(np.bincount(g.edge_row,
                                                           minlength=g.rows))])
    return tuple(torch.as_tensor(x.astype(np.int32), device=device)
                 for x in (row_start, g.edge_col, g.edge_shift))


def decode_layered_plain(llrs: torch.Tensor, bg: int, zc: int,
                         num_iters: int = DEFAULT_ITERS,
                         scaling: float = DEFAULT_SCALING,
                         wire: bool = False, early_stop: bool = False):
    """The kernel's function in plain PyTorch (any device).

    f32 mode follows ``_make_kernel`` (its running min / second-min with the
    ``a == m1`` rule gives the same messages as the argmin form used here);
    wire mode follows ``layered_wire``.  With ``early_stop`` a codeblock stops
    once its own syndrome is zero, as each CTA of the kernel does."""
    _check_input(llrs, bg, zc, wire)
    plan = get_decode_plan(bg, zc)
    l, r_msgs = init_state(llrs, plan, wire)
    strict = not wire
    b = llrs.shape[0]
    sweeps = torch.zeros((b,), dtype=torch.int32, device=llrs.device)
    active = torch.arange(b, device=llrs.device)
    for _ in range(num_iters):
        if not early_stop:
            sweep(l, r_msgs, bg, zc, scaling, wire)
            sweeps += 1
            continue
        if active.numel() == 0:
            break
        if active.numel() == b:
            sweep(l, r_msgs, bg, zc, scaling, wire)
            l_a = l
        else:
            l_a, r_a = l[active], r_msgs[active]
            sweep(l_a, r_a, bg, zc, scaling, wire)
            l[active], r_msgs[active] = l_a, r_a
        sweeps[active] += 1
        done = check_parity(hard_decision(l_a, strict), bg, zc)
        active = active[~done]
    hard = hard_decision(l, strict)
    return hard[:, :plan.kb * zc], check_parity(hard, bg, zc), sweeps


def _int8_input(llrs: torch.Tensor, bg: int, zc: int, b_tile: int
                ) -> torch.Tensor:
    """``decode_pallas_int8``'s checks and input conversion: Zc >= MIN_ZC,
    B % b_tile == 0, clip(round(llrs), ±127) as int8 (round half to even,
    as jnp.round)."""
    if zc < MIN_ZC:
        raise ValueError(f"decode_int8 takes Zc >= {MIN_ZC}, got {zc}")
    g = get_graph(bg, zc)
    if llrs.ndim != 2 or llrs.shape[1] != g.n_full:
        raise ValueError(f"LLRs must be (B, {g.n_full}) for BG{bg} Zc={zc}, "
                         f"got {tuple(llrs.shape)}")
    if b_tile < 1 or llrs.shape[0] % b_tile:
        raise ValueError(f"B = {llrs.shape[0]} is not a multiple of "
                         f"b_tile = {b_tile}")
    if llrs.dtype == torch.int8:          # integers: only -128 moves
        return torch.clamp(llrs, -127, 127).contiguous()
    return torch.clamp(torch.round(llrs.to(torch.float32)), -127, 127
                       ).to(torch.int8).contiguous()


def decode_int8(llrs: torch.Tensor, bg: int, zc: int,
                num_iters: int = DEFAULT_ITERS, b_tile: int = 32,
                early_stop: bool = False, *, with_sweeps: bool = False):
    """K2, ``decode_pallas_int8``'s counterpart: (B, cols*Zc) LLRs (any
    float or integer type in the ±127 wire range) -> (hard (B, kb*Zc) int8,
    ok (B,) bool), plus the sweeps run per codeblock when ``with_sweeps``.

    With ``early_stop`` a tile of ``b_tile`` consecutive codeblocks stops
    once every one of them meets parity; without it the result does not
    depend on ``b_tile``.  A CUDA tensor runs the kernel (or raises); a CPU
    tensor runs ``decode_int8_plain``."""
    x = _int8_input(llrs, bg, zc, b_tile)
    if llrs.device.type == "cpu":
        return decode_int8_plain(x, bg, zc, num_iters, b_tile, early_stop,
                                 with_sweeps=with_sweeps)
    hard, ok, sweeps = _launch(x, MODE_INT8, bg, zc, num_iters, DEFAULT_SCALING,
                               early_stop, b_tile)
    cuda_build.LAUNCHES[KERNEL_INT8] += 1
    return (hard, ok, sweeps) if with_sweeps else (hard, ok)


def decode_int8_plain(llrs: torch.Tensor, bg: int, zc: int,
                      num_iters: int = DEFAULT_ITERS, b_tile: int = 32,
                      early_stop: bool = False, *, with_sweeps: bool = False):
    """K2's function in plain PyTorch (any device): ``_make_kernel_int8``'s
    int32 arithmetic sweep by sweep, ``_iterate_kernel``'s tile exit, hard
    bits ``L < 0`` and ``ok`` = check_parity of the hard bits."""
    x = _int8_input(llrs, bg, zc, b_tile)
    plan = get_decode_plan(bg, zc)
    b, dev = x.shape[0], x.device
    l = x.to(torch.int16)
    r_msgs = torch.zeros((b, plan.rows, plan.max_deg, zc), dtype=torch.int8,
                         device=dev)
    sweeps = torch.zeros((b,), dtype=torch.int32, device=dev)
    active = torch.arange(b, device=dev)
    for _ in range(num_iters):
        if active.numel() == b:
            _sweep_int8(l, r_msgs, bg, zc)
            l_a = l
        else:
            l_a, r_a = l[active], r_msgs[active]
            _sweep_int8(l_a, r_a, bg, zc)
            l[active], r_msgs[active] = l_a, r_a
        sweeps[active] += 1
        if not early_stop:
            continue
        ok_cb = check_parity((l_a < 0).to(torch.int8), bg, zc)
        tile_done = ok_cb.reshape(-1, b_tile).all(dim=1)
        active = active.reshape(-1, b_tile)[~tile_done].reshape(-1)
        if active.numel() == 0:
            break
    hard = (l < 0).to(torch.int8)
    ok = check_parity(hard, bg, zc)
    hard = hard[:, :plan.kb * zc]
    return (hard, ok, sweeps) if with_sweeps else (hard, ok)


def _sweep_int8(l: torch.Tensor, r_msgs: torch.Tensor, bg: int, zc: int
                ) -> None:
    """One K2 sweep over every check row, updating the int16 posterior L
    (B, cols*Zc) and the int8 messages R (B, rows, max_deg, Zc) in place."""
    pt = _plan_tensors(bg, zc, l.device)
    b = l.shape[0]
    for r, (idx, deg) in enumerate(zip(pt.row_idx, pt.row_deg)):
        t = (l[:, idx].reshape(b, deg, zc).to(torch.int32)
             - r_msgs[:, r, :deg].to(torch.int32))
        a = t.abs()
        m1, amin = a.min(dim=1, keepdim=True)       # first of equal minima
        iota = torch.arange(deg, device=l.device).reshape(1, deg, 1)
        first_min = iota == amin
        m2 = torch.where(first_min, 1 << 20, a).amin(dim=1, keepdim=True)
        mag = (torch.where(first_min, m2, m1) * 13) >> 4     # x 0.8125
        neg = (t < 0).sum(dim=1, keepdim=True, dtype=torch.int32) & 1
        flip = (neg ^ (t < 0).to(torch.int32)) != 0
        r_new = torch.clamp(torch.where(flip, -mag, mag), -INT8_CLAMP,
                            INT8_CLAMP)
        l[:, idx] = (t + r_new).reshape(b, -1).to(torch.int16)
        r_msgs[:, r, :deg] = r_new.to(torch.int8)
