"""PUSCH front: the slot receiver's per-RE chain as the CUDA kernel of
``csrc/pusch_front.cu`` and its plain chain.

``demap`` takes the demodulated grid and what the channel estimation made
of each TB row (row r = slot * U + UE): its CFO derotation factor per data
symbol, its equaliser input and its scrambling init, and returns the rows'
descrambled wire LLRs, (rows, ndata * w * L * Qm) int8: the derotation,
the equaliser, the max-log demap (``modulation.demodulate_soft``), the wire
quantisation (``modulation.wire_quantize``) and the descrambling
(``sequences.scramble_llrs``).  The equaliser follows ``eq``'s shape:

  * (rows, w) channel estimate with (rows,) noise variance on a one-port
    (S, nsymb, nsubc) grid: the 1xN MMSE (``equalizer.equalize_mmse_1xn``);
  * (S, U, w, L, P) weights with (S, U, w, L) equalised noise variance on
    a (S, P, nsymb, nsubc) grid, as ``equalizer.mmse_weights_grid`` makes
    them: ``equalizer.mmse_apply_grid``, layer l of RE i giving LLRs
    (i * L + l) * Qm ... (the TS 38.211 layer interleave).

A CUDA tensor launches the kernel (``pusch_demap``, each launch counted in
``cuda_build.LAUNCHES``) or raises; a CPU tensor runs ``demap_plain``, the
plain chain, which the CPU tests and the on-card comparison use.  The
kernel reads each row's Gold sequence from the packed x1 row and x2 basis
of ``pdsch_code.gold_words``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_build
from ..device import host_constant
from ..utils.tracing import cached_build
from . import equalizer, modulation, pdsch_code, sequences

LIBRARY = "pusch_front"
KERNEL = "pusch_demap"
MAX_PORTS = 4


def _geometry(grid: torch.Tensor, eq: torch.Tensor):
    """(slots, ports, layers, w) of a call; layers 0 is the 1xN MMSE."""
    if eq.ndim == 2:
        return grid.shape[0], 1, 0, eq.shape[1]
    return eq.shape[0], eq.shape[4], eq.shape[3], eq.shape[2]


def demap_plain(grid: torch.Tensor, symbols, band0: int, nof_ue: int,
                eq: torch.Tensor, nv: torch.Tensor, rot: torch.Tensor | None,
                c_init: torch.Tensor, modulation_name: str) -> torch.Tensor:
    """The plain chain of ``demap`` on any device."""
    s, p, n_l, w = _geometry(grid, eq)
    u, ndata = nof_ue, len(symbols)
    dev = grid.device
    band = grid[..., band0:band0 + u * w]
    if n_l == 0:
        y = band[:, host_constant(symbols, dev)]              # (S, ndata, span)
        y = y.reshape(s, ndata, u, w).permute(0, 2, 1, 3).reshape(s * u, ndata, w)
        if rot is not None:
            y = y * rot[:, :, None]
        hh = eq[:, None, :].expand(y.shape)
        x_hat, nv_out = equalizer.equalize_mmse_1xn(y[None], hh[None],
                                                    nv[None, :, None, None])
        x, nv_x = x_hat.reshape(s * u, ndata * w), nv_out.reshape(s * u, ndata * w)
    else:
        y = band[:, :, host_constant(symbols, dev)].reshape(s, p, ndata, u, w)
        if rot is not None:
            y = y * rot.reshape(s, u, ndata).transpose(1, 2)[:, None, :, :, None]
        x = equalizer.mmse_apply_grid(y, eq).permute(0, 2, 1, 3, 4)  # (S, U, n, w, L)
        nv_x = nv[:, :, None].expand(x.shape)
    llr = modulation.demodulate_soft(x, nv_x, modulation_name, quantize=False)
    g = ndata * w * max(n_l, 1) * modulation.QM[modulation_name]
    llr = modulation.wire_quantize(llr, modulation_name).reshape(s * u, g)
    return sequences.scramble_llrs(llr, c_init).to(torch.int8)


@cached_build
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(LIBRARY)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pusch_demap.argtypes = ([ptr] * 8 + [ctypes.c_uint] + [i32] * 10 + [f32] * 3
                                + [ptr])
    lib.pusch_demap.restype = i32
    return lib


def demap(grid: torch.Tensor, symbols, band0: int, nof_ue: int,
          eq: torch.Tensor, nv: torch.Tensor, rot: torch.Tensor | None,
          c_init: torch.Tensor, modulation_name: str) -> torch.Tensor:
    """(rows, ndata * w * L * Qm) int8 descrambled wire LLRs of the TB rows
    of ``grid`` (the module docstring gives the two forms of ``eq`` and
    ``nv``).  ``symbols``: the grid symbols that carry data, in increasing
    order; UE u's subcarriers start at ``band0 + u * w``.  ``rot`` (rows,
    ndata) complex64 multiplies each row's data symbols (None: no
    derotation); ``c_init`` (rows,) are the rows' scrambling inits."""
    if grid.device.type == "cpu":
        return demap_plain(grid, symbols, band0, nof_ue, eq, nv, rot, c_init,
                           modulation_name)
    if grid.device.type != "cuda":
        raise ValueError(f"no {KERNEL} kernel for device {grid.device}")
    s, p, n_l, w = _geometry(grid, eq)
    rows, ndata, qm = s * nof_ue, len(symbols), modulation.QM[modulation_name]
    nsymb, nsubc = grid.shape[-2:]
    symbols = [int(x) for x in symbols]
    if n_l == 0:
        shapes = {"grid": (grid.shape, (s, nsymb, nsubc)), "eq": (eq.shape, (rows, w)),
                  "nv": (nv.shape, (rows,))}
    else:
        shapes = {"grid": (grid.shape, (s, p, nsymb, nsubc)),
                  "nv": (nv.shape, (s, nof_ue, w, n_l))}
    shapes["c_init"] = (c_init.shape, (rows,))
    if rot is not None:
        shapes["rot"] = (rot.shape, (rows, ndata))
    for name, (got, want) in shapes.items():
        if tuple(got) != tuple(want):
            raise ValueError(f"{name} must be {tuple(want)}, got {tuple(got)}")
    if eq.shape[1] != nof_ue and n_l:
        raise ValueError(f"weights for {eq.shape[1]} UEs, not {nof_ue}")
    if n_l not in (0, 1, 2, 4) or p > MAX_PORTS:
        raise ValueError(f"{n_l} layers from {p} ports: the kernel takes 1, 2 or 4 "
                         f"layers from at most {MAX_PORTS} ports")
    if sorted(set(symbols)) != symbols or not symbols or symbols[-1] >= nsymb \
            or symbols[0] < 0:
        raise ValueError(f"data symbols must increase within 0..{nsymb - 1}: {symbols}")
    if band0 < 0 or band0 + nof_ue * w > nsubc:
        raise ValueError(f"UE span {band0} + {nof_ue} x {w} leaves {nsubc} subcarriers")
    dev = grid.device
    g = ndata * w * max(n_l, 1) * qm
    out = torch.empty((rows, g), dtype=torch.int8, device=dev)
    if rows == 0:
        return out
    grid = grid.to(torch.complex64).contiguous()
    eq = eq.to(device=dev, dtype=torch.complex64).contiguous()
    nv = nv.to(device=dev, dtype=torch.float32).contiguous()
    if rot is not None:
        rot = rot.to(device=dev, dtype=torch.complex64).contiguous()
    c_init = c_init.to(device=dev, dtype=torch.int64).contiguous()
    x1, basis = pdsch_code.gold_on(g, dev)
    rl = modulation.RANGE_LIMIT_PSK if qm <= 2 else modulation.RANGE_LIMIT
    amp = modulation._axis_amplitude(qm // 2) if qm > 1 else 0.0
    # The plain chain's ``/ (2a)`` on a CUDA tensor multiplies by the
    # float32 reciprocal of the host scalar.
    inv_two_amp = float(np.float32(1.0) / np.float32(2.0 * amp)) if qm > 1 else 0.0
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.pusch_demap(
            grid.data_ptr(), eq.data_ptr(), nv.data_ptr(),
            None if rot is None else rot.data_ptr(), c_init.data_ptr(),
            x1.data_ptr(), basis.data_ptr(), out.data_ptr(),
            sum(1 << x for x in symbols), rows, nof_ue, w, ndata, nsymb, nsubc,
            band0, p, n_l, qm, amp, inv_two_amp,
            float(np.float32(modulation.LLR_MAX / rl)),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {rc}")
    cuda_build.LAUNCHES[KERNEL] += 1
    return out
