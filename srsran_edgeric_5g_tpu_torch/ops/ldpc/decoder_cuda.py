"""Layered min-sum LDPC decoder: the CUDA kernel and its plain twin.

Port of the Pallas TPU kernel ``srsran_edgeric_5g_tpu/ops/ldpc/
decoder_pallas.py`` (K1, ``decode_pallas``).  The kernel is
``csrc/ldpc_layered.cu`` (one CTA per codeblock, Zc lanes on the thread
axis, the posterior in shared memory; its header says what bounds it).  It
has two modes:

  * f32 (``wire=False``): ``decode_pallas``'s normalised min-sum
    (α = 0.8, hard bits ``post < 0``), which ``decode(schedule="pallas")``
    computes;
  * wire (``wire=True``): the reference's ``layered_wire`` semantics on int8
    wire-domain input, which the main path's ``decode(schedule="wire_auto")``
    computes.

``decode_layered`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs ``decode_layered_plain``, the same function
in plain PyTorch, which the CPU tests and the on-card comparison use.
Early stop is per codeblock in both (the JAX schedules stop per batch), so
bit-exact comparisons with the reference run with ``early_stop=False``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import cuda_build
from .decoder import (DEFAULT_ITERS, DEFAULT_SCALING, check_parity,
                      get_decode_plan, hard_decision, init_state, sweep)
from .graph import get_graph

KERNEL = "ldpc_layered"
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
    if llrs.device.type != "cuda":
        raise ValueError(f"no {KERNEL} kernel for device {llrs.device}")
    if not cuda_supported(zc):
        raise ValueError(f"{KERNEL} takes {MIN_ZC} <= Zc <= {MAX_ZC}, got {zc}")
    if not llrs.is_contiguous():
        raise ValueError("LLRs must be contiguous")
    g = get_graph(bg, zc)
    if g.max_row_degree() > MAX_DEG:
        raise ValueError(f"row degree {g.max_row_degree()} > {MAX_DEG}")
    dev = llrs.device
    b = llrs.shape[0]
    row_start, edge_col, edge_shift = _edge_tables(bg, zc, dev)
    hard = torch.empty((b, g.kb * zc), dtype=torch.int8, device=dev)
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    sweeps = torch.empty((b,), dtype=torch.int32, device=dev)
    r_scratch = None if wire else torch.empty((b, g.num_edges, zc),
                                              dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ldpc_layered_decode(
            llrs.data_ptr(), int(wire), hard.data_ptr(), ok.data_ptr(),
            sweeps.data_ptr(), 0 if r_scratch is None else r_scratch.data_ptr(),
            row_start.data_ptr(), edge_col.data_ptr(), edge_shift.data_ptr(),
            b, g.rows, g.cols, g.kb, g.num_edges, zc, num_iters,
            float(np.float32(scaling)), int(scaling * 65536), int(early_stop),
            stream)
    if rc != 0:
        smem = lib.ldpc_layered_smem_bytes(int(wire), g.rows, g.cols,
                                           g.num_edges, zc)
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {rc} "
                           f"(BG{bg} Zc={zc}, {smem} B shared memory per block)")
    cuda_build.LAUNCHES[KERNEL] += 1
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
        l_a, r_a = l[active], r_msgs[active]
        sweep(l_a, r_a, bg, zc, scaling, wire)
        l[active], r_msgs[active] = l_a, r_a
        sweeps[active] += 1
        done = check_parity(hard_decision(l_a, strict), bg, zc)
        active = active[~done]
    hard = hard_decision(l, strict)
    return hard[:, :plan.kb * zc], check_parity(hard, bg, zc), sweeps
