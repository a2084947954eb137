"""LDPC rate matching / dematching (TS 38.212 §5.4.2).

Port of ``srsran_edgeric_5g_tpu/ops/ldpc/rate_match.py``: for each static
configuration (BG, Zc, E, rv, Qm, filler span, N_cb) the select-skip-wrap-
interleave composition is ONE precomputed index vector, so rate matching is
a single gather and dematching a single scatter-add (``index_add_``) of LLRs
into the circular buffer — HARQ soft combining comes free from the add.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graph import get_graph
from ...utils.tracing import cached_build

# k0 numerators per TS 38.212 Table 5.4.2.1-2 (k0 = Zc*floor(num*Ncb/(den*Zc))).
_K0_FRAC = {1: {0: 0, 1: 17, 2: 33, 3: 56}, 2: {0: 0, 1: 13, 2: 25, 3: 43}}
_K0_DEN = {1: 66, 2: 50}

FILLER_LLR = 127.0  # effectively-infinite positive LLR for known-zero fillers


def k0_offset(bg: int, rv: int, n_cb: int, zc: int) -> int:
    return zc * ((_K0_FRAC[bg][rv] * n_cb) // (_K0_DEN[bg] * zc))


def lbrm_n_cb(bg: int, zc: int, nof_cb: int, tbs_lbrm: int) -> int:
    """Limited-buffer rate matching buffer size (TS 38.212 §5.4.2.1):
    N_cb = min(N, N_ref) with N_ref = floor(TBS_LBRM / (C * 2/3))."""
    return min(get_graph(bg, zc).n, (3 * tbs_lbrm) // (2 * nof_cb))


# eq=False: plans are cached per key, so identity is equality (and the
# index array keeps the generated __eq__/__hash__ from working).
@dataclasses.dataclass(frozen=True, eq=False)
class RateMatchPlan:
    bg: int
    zc: int
    e: int                   # rate-matched output length
    rv: int
    qm: int
    k_prime: int             # message bits incl. CRC, excl. fillers
    n_cb: int
    select_idx: np.ndarray   # (E,) indices into the N_cb circular buffer
    injective: bool          # no buffer position is selected twice (E <= N_cb)


@cached_build
def get_rate_match_plan(bg: int, zc: int, e: int, rv: int, qm: int,
                        k_prime: int, n_cb: int | None = None) -> RateMatchPlan:
    """Build the fused selection + interleave index vector.

    The circular buffer holds N_cb = N = (cols-2)*Zc bits (LBRM shortens
    it); positions [k_prime - 2*Zc, K - 2*Zc) are filler bits, skipped by
    selection.  The output interleaver writes e_k column-major into an
    (E/Qm, Qm) array read row-major (TS 38.212 §5.4.2.2).
    """
    g = get_graph(bg, zc)
    n_cb = g.n if n_cb is None else n_cb
    if e % qm:
        raise ValueError(f"E={e} is not a multiple of Qm={qm}")
    f_begin = k_prime - 2 * zc
    f_end = g.k - 2 * zc

    k0 = k0_offset(bg, rv, n_cb, zc)
    sel = np.empty(e, dtype=np.int64)
    k, j = 0, 0
    while k < e:
        idx = (k0 + j) % n_cb
        if not (f_begin <= idx < f_end):
            sel[k] = idx
            k += 1
        j += 1
    # Interleave: f(i + j*Qm) = e(i*(E/Qm) + j).
    rows = e // qm
    i, jj = np.meshgrid(np.arange(qm), np.arange(rows), indexing="ij")
    order = (i * rows + jj).T.reshape(-1)     # output position p -> e index
    fused = sel[order]
    injective = np.bincount(fused, minlength=n_cb).max() <= 1
    return RateMatchPlan(bg=bg, zc=zc, e=e, rv=rv, qm=qm, k_prime=k_prime,
                         n_cb=n_cb, select_idx=fused, injective=bool(injective))


@cached_build
def _plan_tensors(plan: RateMatchPlan, device: torch.device):
    g = get_graph(plan.bg, plan.zc)
    pos = np.arange(plan.n_cb)
    filler = (pos >= plan.k_prime - 2 * plan.zc) & (pos < g.k - 2 * plan.zc)
    return (torch.as_tensor(plan.select_idx, device=device),
            torch.as_tensor(filler, device=device))


def rate_match(full_codeword: torch.Tensor, plan: RateMatchPlan) -> torch.Tensor:
    """(B, cols*Zc) encoder output -> (B, E) transmitted bits: drop the first
    2*Zc systematic bits (puncture), then one fused selection/interleave
    gather."""
    idx, _ = _plan_tensors(plan, full_codeword.device)
    buf = full_codeword[:, 2 * plan.zc: 2 * plan.zc + plan.n_cb]
    return buf[:, idx]


def rate_dematch(llrs: torch.Tensor, plan: RateMatchPlan,
                 soft_buffer: torch.Tensor | None = None,
                 dtype: torch.dtype = torch.float32,
                 saturate: bool = False) -> torch.Tensor:
    """(B, E) LLRs -> (B, cols*Zc) decoder input, soft-combining into
    ``soft_buffer`` (HARQ) when given.

    Repeated buffer positions accumulate, punctured systematic positions
    stay 0, fillers get +FILLER_LLR (known zero).

    ``dtype``/``saturate``: the int8-wire-domain path runs the combine in
    bf16 (every value is an integer, |llr| <= 120 and |soft| <= 127, so sums
    <= 247 are exact in bf16 as in float32) and clips the combined buffer to
    ±127 once per call — the reference's saturated LLR sum.
    """
    g = get_graph(plan.bg, plan.zc)
    b = llrs.shape[0]
    zc = plan.zc
    idx, filler = _plan_tensors(plan, llrs.device)
    if soft_buffer is None:
        buf = torch.zeros((b, plan.n_cb), dtype=dtype, device=llrs.device)
    else:
        buf = soft_buffer.to(dtype).clone()
    if plan.injective and soft_buffer is None:
        buf[:, idx] = llrs.to(dtype)
    else:
        buf.index_add_(1, idx, llrs.to(dtype))
    if saturate:
        buf = torch.clamp(buf, -FILLER_LLR, FILLER_LLR)
    buf = buf.masked_fill(filler, FILLER_LLR)
    return torch.cat([buf.new_zeros((b, 2 * zc)), buf,
                      buf.new_zeros((b, g.n_full - 2 * zc - plan.n_cb))], dim=-1)
