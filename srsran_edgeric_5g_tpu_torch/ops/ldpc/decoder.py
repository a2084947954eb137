"""LDPC layered normalised min-sum decoder (TS 38.212 base graphs).

Port of ``srsran_edgeric_5g_tpu/ops/ldpc/decoder.py``: the decode plan, the
min-sum check update, the gather formulation of the ``layered`` and
``layered_wire`` schedules with their batch-granularity early stop, the
``flooding`` schedule and the reference's int8 arithmetic
(``layered_rolls_i8``) as plain torch on any device, the parity check, and
the ``decode`` dispatch.  ``auto``, ``wire_auto`` and ``pallas`` on a CUDA
tensor run the hand-written kernel in ``decoder_cuda``.  The reference's
other schedules are TPU formulations (lane rolls, wave packing, compressed
or bf16 message storage) of ``layered`` or ``layered_wire`` and are refused
with the name of the schedule that computes the same decode.

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

from ..modulation import LLR_MAX, RANGE_LIMIT
from .graph import get_graph

DEFAULT_SCALING = 0.8
DEFAULT_ITERS = 6  # reference default (ldpc_decoder_impl.h:216)

# The reference's TPU formulations, each with the port's schedule that
# computes the same decode (the bf16 forms round their message storage).
_TPU_FORMS = {
    "layered_rolls": "layered", "layered_rolls_bf16": "layered",
    "layered_rolls_mixed": "layered", "layered_rolls_cr": "layered",
    "layered_rolls_cr_f32": "layered", "layered_waves": "layered",
    "layered_waves_bf16": "layered",
    "layered_rolls_wire": "layered_wire", "layered_rolls_wire_i8s": "layered_wire",
}

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
           schedule: str = "auto",
           early_stop: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode (B, cols*Zc) LLRs -> (hard message bits (B, kb*Zc) int8,
    parity_ok (B,) bool).

    The input covers the full codeword including the 2*Zc punctured
    systematic positions (0) and filler positions (large positive LLR).

    ``schedule``:
      * 'layered': f32 normalised min-sum, gather formulation, early stop
        once every codeword of the batch satisfies parity.
      * 'layered_wire': the reference's int8-wire semantics (±64 load clamp,
        ±120 v2c saturation, truncating 0.8 scale, ±127 promotion, LLR == 0
        -> bit 1) on wire-domain inputs; bit-identical to the reference's
        avx2 decoder.
      * 'wire_auto': the main path's decode.  On a CUDA tensor the layered
        kernel in wire mode (``decoder_cuda``; per-codeblock early stop); on
        a CPU tensor 'layered_wire'.  Wire-domain values are integers by
        contract (wire_quantize and the saturated dematch), so a float input
        goes to the kernel as int8 after the ±64 load clamp.
      * 'pallas': the kernel's f32 mode (``decode_pallas`` semantics: fixed
        sweeps, hard bits ``post < 0``, Zc >= 64 on the card); its plain
        version on a CPU tensor.
      * 'auto' (the default, as the reference's): the reference resolves
        it to 'layered' on every backend but the TPU.  On a CPU tensor it
        is 'layered'; on a CUDA tensor the
        kernel's f32 mode with 'layered''s hard rule ``l <= 0`` at every
        lifting size, exiting per codeblock (the batch exit of 'layered'
        gives the same bits on every input measured: ROADMAP.md Queue C).
      * 'flooding': every check row updated in parallel from one
        posterior per iteration, ``num_iters`` iterations (no early stop),
        f32; plain torch on any device.
      * 'layered_rolls_i8': the reference's fixed-point decoder arithmetic
        (int8 wire load, saturating v2c, truncating scale, ±127 promotion)
        in int32 lanes, batch early stop; plain torch on any device.
    """
    if schedule == "auto":
        if llrs.device.type == "cpu":
            schedule = "layered"
        else:
            from .decoder_cuda import decode_layered
            hard, ok, _ = decode_layered(llrs.to(torch.float32).contiguous(),
                                         bg, zc, num_iters, scaling, wire=False,
                                         early_stop=early_stop, strict=False)
            return hard, ok
    if schedule in ("wire_auto", "pallas"):
        from .decoder_cuda import decode_layered
        if schedule == "pallas":
            hard, ok, _ = decode_layered(llrs.to(torch.float32), bg, zc,
                                         num_iters, scaling, wire=False,
                                         early_stop=False)
            return hard, ok
        if llrs.device.type == "cpu":
            return _decode_layered(llrs, bg, zc, num_iters, scaling, True,
                                   early_stop)
        if llrs.dtype != torch.int8:
            llrs = torch.clamp(llrs, -WIRE_LOAD_CLAMP, WIRE_LOAD_CLAMP
                               ).to(torch.int8)
        hard, ok, _ = decode_layered(llrs, bg, zc, num_iters, scaling,
                                     wire=True, early_stop=early_stop)
        return hard, ok
    if schedule == "flooding":
        return _decode_flooding(llrs, bg, zc, num_iters, scaling)
    if schedule == "layered_rolls_i8":
        return _decode_layered_i8(llrs, bg, zc, num_iters, scaling, early_stop)
    if schedule in _TPU_FORMS:
        raise NotImplementedError(
            f"decode schedule {schedule!r} is the reference's TPU formulation "
            f"of {_TPU_FORMS[schedule]!r}; decode with schedule="
            f"{_TPU_FORMS[schedule]!r} (or 'wire_auto' / 'auto', which run "
            "the CUDA kernel on the card)")
    if schedule not in ("layered", "layered_wire"):
        raise ValueError(f"unknown decode schedule {schedule!r}")
    return _decode_layered(llrs, bg, zc, num_iters, scaling,
                           schedule == "layered_wire", early_stop)


def _decode_layered(llrs, bg, zc, num_iters, scaling, wire, early_stop):
    """'layered' / 'layered_wire': batch-granularity early stop (the
    reference's CRC early stop, ldpc_decoder_impl.cpp:125-133, exiting once
    every codeword in the call satisfies parity)."""
    plan = get_decode_plan(bg, zc)
    l, r_msgs = init_state(llrs, plan, wire)
    for _ in range(num_iters):
        sweep(l, r_msgs, bg, zc, scaling, wire)
        if early_stop and bool(check_parity(hard_decision(l), bg, zc).all()):
            break
    hard = hard_decision(l)
    return hard[:, :plan.kb * zc], check_parity(hard, bg, zc)


def _decode_flooding(llrs, bg, zc, num_iters, scaling):
    """Flooding schedule: per iteration every check row at once,
    t = (Lch + scatter_add(R))[edges] - R, R' = minsum(t)."""
    plan = get_decode_plan(bg, zc)
    pt = _plan_tensors(bg, zc, llrs.device)
    b = llrs.shape[0]
    n_full = plan.cols * zc
    lmask = pt.mask[None]                                      # (1, rows, deg, 1)
    # One dummy slot at the end absorbs the padded edges (their R is 0).
    lch = torch.cat([llrs.to(torch.float32),
                     llrs.new_zeros((b, 1), dtype=torch.float32)], dim=-1)

    def posterior(r_msgs):
        return lch.index_add(1, pt.gather_flat, r_msgs.reshape(b, -1))

    r_msgs = torch.zeros((b, plan.rows, plan.max_deg, zc), dtype=torch.float32,
                         device=llrs.device)
    for _ in range(num_iters):
        t = posterior(r_msgs)[:, pt.gather_flat].reshape(r_msgs.shape) - r_msgs
        r_msgs = _minsum(t, lmask, scaling, deg_axis=2)
    hard = hard_decision(posterior(r_msgs)[:, :n_full])
    return hard[:, :plan.kb * zc], check_parity(hard, bg, zc)


def _decode_layered_i8(llrs, bg, zc, num_iters, scaling, early_stop):
    """'layered_rolls_i8': layered min-sum in the reference decoder's
    fixed-point semantics (ldpc_decoder_avx2.cpp, log_likelihood_ratio.h),
    in int32 lanes holding int8 values.

      * an int8 input is the wire; a float input is wire-quantised first
        (round(x * 120/20), clipped to ±120);
      * load clamps the posteriors to ±64; finite LLRs live in [-120, 120],
        ±127 marks a fixed bit;
      * v2c = L - R saturates at ±120, but an infinite L stays infinite;
      * min trackers start at 120; the 0.8 scale truncates
        (floor(mag * floor(0.8 * 2^16) / 2^16)) and skips infinities;
      * the posterior update is a promotion sum: beyond ±120 the bit is
        pinned at ±127.
    The lane rolls of the reference are the plan's gathers here (the same
    edge order per row, so the first-min tie rule picks the same edge)."""
    plan = get_decode_plan(bg, zc)
    pt = _plan_tensors(bg, zc, llrs.device)
    b = llrs.shape[0]
    maxv, inf = int(WIRE_LLR_MAX), int(WIRE_LLR_INF)
    if llrs.dtype == torch.int8:
        q = llrs.to(torch.int32)
    else:
        q = torch.clamp(torch.round(llrs.to(torch.float32) * float(
            np.float32(LLR_MAX / RANGE_LIMIT))), -LLR_MAX, LLR_MAX).to(torch.int32)
    l = torch.clamp(q, -int(WIRE_LOAD_CLAMP), int(WIRE_LOAD_CLAMP))
    r_msgs = torch.zeros((b, plan.rows, plan.max_deg, zc), dtype=torch.int32,
                         device=llrs.device)
    scale16 = int(scaling * 65536)

    def sweep_i8():
        for r, (idx, deg) in enumerate(zip(pt.row_idx, pt.row_deg)):
            le = l[:, idx].reshape(b, deg, zc)
            t = torch.clamp(le - r_msgs[:, r, :deg], -maxv, maxv)
            t = torch.where(le.abs() >= inf, le, t)           # inf propagates
            at = torch.clamp(t.abs(), max=maxv)
            m1 = at.amin(dim=1, keepdim=True)
            first_min = (torch.arange(deg, device=l.device)[:, None]
                         == at.argmin(dim=1, keepdim=True))
            m2 = torch.where(first_min, inf, at).amin(dim=1, keepdim=True)
            mag = torch.where(first_min, m2, m1)
            mag = torch.where(mag >= inf, inf, (mag * scale16) >> 16)
            neg = t < 0
            sign_all = (neg.sum(dim=1, keepdim=True) & 1) == 1
            r_new = torch.where(sign_all ^ neg, -mag, mag)
            v = t + r_new
            t_p, t_n = t > maxv, t < -maxv
            r_p, r_n = r_new > maxv, r_new < -maxv
            v = torch.where(v > maxv, inf, torch.where(v < -maxv, -inf, v))
            v = torch.where((t_p & ~r_n) | (r_p & ~t_n), inf, v)
            v = torch.where((t_n & ~r_p) | (r_n & ~t_p), -inf, v)
            l[:, idx] = v.reshape(b, -1)
            r_msgs[:, r, :deg] = r_new

    for _ in range(num_iters):
        sweep_i8()
        if early_stop and bool(check_parity(hard_decision(l), bg, zc).all()):
            break
    hard = hard_decision(l)
    return hard[:, :plan.kb * zc], check_parity(hard, bg, zc)


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
