"""LDPC layered normalised min-sum decoder (TS 38.212 base graphs).

The plain decoder of the benchmark's reference: the decode plan, the
min-sum check update, the gather formulation of the layered schedule in
f32 or in the reference's int8-wire semantics, its batch-granularity early
stop, and the parity check, as plain torch on any device.

State per layer r: posterior LLRs L (B, cols*Zc) and check-to-variable
messages R (B, rows, max_deg, Zc).  Update:
    t = L[edges(r)] - R[r]           (variable-to-check, extrinsic)
    R'[e] = 0.8 * sign_prod/sign(t_e) * min_{e' != e} |t_{e'}|
    L[edges(r)] = t + R'
LLR convention: positive <=> bit 0.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .graph import get_graph

DEFAULT_SCALING = 0.8
DEFAULT_ITERS = 6  # reference default (ldpc_decoder_impl.h:216)

# Wire-domain limits (reference int8 LLR semantics): load clamp, v2c
# saturation / min-tracker cap, and the value a pinned (fixed) bit takes.
WIRE_LOAD_CLAMP = 64.0
WIRE_LLR_MAX = 120.0
WIRE_LLR_INF = 127.0


@dataclasses.dataclass(frozen=True, eq=False)
class DecodePlan:
    bg: int
    zc: int
    rows: int
    cols: int
    kb: int
    max_deg: int
    gather_idx: np.ndarray   # (rows, max_deg*Zc) into flat L; pad -> cols*Zc
    mask: np.ndarray         # (rows, max_deg) bool


@functools.lru_cache(maxsize=None)
def get_decode_plan(bg: int, zc: int) -> DecodePlan:
    g = get_graph(bg, zc)
    max_deg = g.max_row_degree()
    z = np.arange(zc)
    n_full = g.cols * zc
    idx = np.full((g.rows, max_deg, zc), n_full, dtype=np.int64)
    mask = np.zeros((g.rows, max_deg), dtype=bool)
    slot = np.zeros(g.rows, dtype=np.int64)
    for r, c, s in zip(g.edge_row, g.edge_col, g.edge_shift):
        j = slot[r]
        idx[r, j] = c * zc + (z + s) % zc
        mask[r, j] = True
        slot[r] += 1
    return DecodePlan(bg=bg, zc=zc, rows=g.rows, cols=g.cols, kb=g.kb,
                      max_deg=max_deg,
                      gather_idx=idx.reshape(g.rows, max_deg * zc), mask=mask)


@dataclasses.dataclass(frozen=True, eq=False)
class _PlanTensors:
    row_idx: tuple[torch.Tensor, ...]  # per row: (deg_r*Zc,) gather into flat L
    row_deg: tuple[int, ...]
    gather_flat: torch.Tensor          # (rows*max_deg*Zc,) padded, for parity
    mask: torch.Tensor                 # (rows, max_deg, 1) bool


@functools.lru_cache(maxsize=None)
def _plan_tensors(bg: int, zc: int, device: torch.device) -> _PlanTensors:
    plan = get_decode_plan(bg, zc)
    deg = plan.mask.sum(axis=1)
    idx = plan.gather_idx.reshape(plan.rows, plan.max_deg, zc)
    return _PlanTensors(
        row_idx=tuple(torch.as_tensor(idx[r, :deg[r]].reshape(-1), device=device)
                      for r in range(plan.rows)),
        row_deg=tuple(int(d) for d in deg),
        gather_flat=torch.as_tensor(plan.gather_idx.reshape(-1), device=device),
        mask=torch.as_tensor(plan.mask[:, :, None], device=device))


def decode(llrs: torch.Tensor, bg: int, zc: int,
           num_iters: int = DEFAULT_ITERS,
           scaling: float = DEFAULT_SCALING,
           early_stop: bool = True,
           wire: bool = True) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode (B, cols*Zc) LLRs -> (hard message bits (B, kb*Zc) int8,
    parity_ok (B,) bool, sweeps (B,) int32).

    Layered normalised min-sum with the batch early stop of the
    reference's CRC exit (ldpc_decoder_impl.cpp:125-133): the sweeps stop
    once every codeword of the call satisfies parity.  ``wire`` takes the
    int8-wire semantics (±64 load clamp, ±120 v2c saturation, truncating
    0.8 scale, ±127 promotion, LLR == 0 -> bit 1), bit-identical to the
    reference's avx2 decoder; without it, f32 min-sum.

    ``sweeps`` is, per codeword, the first sweep after which its own
    syndrome was zero (``num_iters`` if it never was): the work that a
    decoder exiting per codeword does on these inputs."""
    plan = get_decode_plan(bg, zc)
    l, r_msgs = init_state(llrs, plan, wire)
    b = llrs.shape[0]
    sweeps = torch.full((b,), num_iters, dtype=torch.int32, device=llrs.device)
    for it in range(num_iters):
        if b:
            sweep(l, r_msgs, bg, zc, scaling, wire)
        ok = check_parity(hard_decision(l), bg, zc)
        sweeps = torch.where(ok & (sweeps == num_iters),
                             torch.full_like(sweeps, it + 1), sweeps)
        if early_stop and bool(ok.all()):
            break
    hard = hard_decision(l)
    return hard[:, :plan.kb * zc], check_parity(hard, bg, zc), sweeps


def init_state(llrs: torch.Tensor, plan: DecodePlan, wire: bool):
    """(posterior L (B, cols*Zc) f32, messages R (B, rows, max_deg, Zc) = 0)."""
    l0 = llrs.to(torch.float32).clone()
    if wire:
        l0 = torch.clamp(l0, -WIRE_LOAD_CLAMP, WIRE_LOAD_CLAMP)  # soft_bits_clamp
    r0 = torch.zeros((llrs.shape[0], plan.rows, plan.max_deg, plan.zc),
                     dtype=torch.float32, device=llrs.device)
    return l0, r0


def hard_decision(l: torch.Tensor, strict: bool = False) -> torch.Tensor:
    """Hard bits of a posterior.  The layered schedules map LLR == 0 to
    bit 1 (srsran hard_decision: integer posteriors hit exact zero);
    ``strict`` is ``decode_pallas``'s ``post < 0``."""
    return ((l < 0) if strict else (l <= 0)).to(torch.int8)


def sweep(l: torch.Tensor, r_msgs: torch.Tensor, bg: int, zc: int,
          scaling: float, wire: bool) -> None:
    """One layered sweep over every check row, updating L and R in place."""
    pt = _plan_tensors(bg, zc, l.device)
    b = l.shape[0]
    for r, (idx, deg) in enumerate(zip(pt.row_idx, pt.row_deg)):
        lg = l[:, idx].reshape(b, deg, zc)
        t = lg - r_msgs[:, r, :deg]
        if wire:
            t = torch.clamp(t, -WIRE_LLR_MAX, WIRE_LLR_MAX)    # v2c saturation
            t = torch.where(lg.abs() > WIRE_LLR_MAX, lg, t)    # ±127-pinned
        r_new = _minsum(t, None, scaling, deg_axis=1, scale_floor=wire)
        l_new = t + r_new
        if wire:
            # promotion_sum incl. infinite addends (avx2 compute_soft_bits):
            # |sum| > 120 pins at ±127; an infinite t or c2v forces its sign
            # unless both are infinite with opposite signs.
            lim, pin = WIRE_LLR_MAX, WIRE_LLR_INF
            t_p, t_n = t > lim, t < -lim
            r_p, r_n = r_new > lim, r_new < -lim
            l_new = torch.where(l_new > lim, pin,
                                torch.where(l_new < -lim, -pin, l_new))
            l_new = torch.where((t_p & ~r_n) | (r_p & ~t_n), pin, l_new)
            l_new = torch.where((t_n & ~r_p) | (r_n & ~t_p), -pin, l_new)
        l[:, idx] = l_new.reshape(b, -1)
        r_msgs[:, r, :deg] = r_new


def _minsum(t: torch.Tensor, lmask: torch.Tensor | None, scaling: float,
            deg_axis: int, scale_floor: bool = False) -> torch.Tensor:
    """Normalised min-sum check update along ``deg_axis`` (``lmask`` None =
    every slot is an edge).

    The first minimum is the lowest-index argmin (torch.argmin returns the
    first of equal minima, as jnp.argmin does); every other slot gets m1, the
    first-min slot gets the minimum over the others, m2 (== m1 on a tie).

    ``scale_floor`` replicates the reference avx2 scale_epi8 exactly:
    floor(mag * floor(scaling * 2^16) / 2^16), with min trackers capped at
    120 and magnitudes > 120 passed through unscaled."""
    big = 1e30
    at = t.abs()
    if scale_floor:
        at = torch.clamp(at, max=WIRE_LLR_MAX)
    if lmask is not None:
        at = torch.where(lmask, at, big)
    st = torch.where(t < 0, -1.0, 1.0)
    m1 = at.amin(dim=deg_axis, keepdim=True)
    amin = at.argmin(dim=deg_axis, keepdim=True)
    shape = [1] * at.ndim
    shape[deg_axis] = at.shape[deg_axis]
    iota = torch.arange(at.shape[deg_axis], device=t.device).reshape(shape)
    first_min = iota == amin
    m2 = torch.where(first_min, big, at).amin(dim=deg_axis, keepdim=True)
    mag = torch.where(first_min, m2, m1)
    if scale_floor:
        sf16 = float(int(scaling * 65536))
        mag = torch.where(mag > WIRE_LLR_MAX, mag,
                          torch.floor(mag * sf16 * (1.0 / 65536.0)))
    else:
        mag = scaling * mag
    if lmask is not None:
        st_m = torch.where(lmask, st, 1.0)
    else:
        st_m = st
    sign_all = st_m.prod(dim=deg_axis, keepdim=True)
    out = (sign_all * st) * mag
    return out if lmask is None else torch.where(lmask, out, 0.0)


def check_parity(hard_bits: torch.Tensor, bg: int, zc: int) -> torch.Tensor:
    """Syndrome check: all checks satisfied per codeword, (B, cols*Zc) -> (B,)
    bool.  Row sums of the hard bits over each check row must be even."""
    plan = get_decode_plan(bg, zc)
    pt = _plan_tensors(bg, zc, hard_bits.device)
    b = hard_bits.shape[0]
    ext = torch.cat([hard_bits.to(torch.int8),
                     hard_bits.new_zeros((b, 1), dtype=torch.int8)], dim=-1)
    gathered = ext[:, pt.gather_flat].reshape(b, plan.rows, plan.max_deg, zc)
    sums = torch.where(pt.mask, gathered, 0).sum(dim=2, dtype=torch.int32)
    return torch.all((sums % 2) == 0, dim=2).all(dim=1)
