"""Successive-cancellation list (SCL) polar decoder, batched.

Port of ``srsran_edgeric_5g_tpu/ops/polar/list_decoder.py`` (the reference's
SCL paths in polar_decoder_impl.cpp), in its functional formulation: every
recursion step returns, besides its partial-sum block, the path permutation
its pruning induced (new path index -> surviving parent index).  The parent
applies that permutation to the alphas it holds before the g-branch and
composes permutations upward.  All state is (B, L, ...) tensors; pruning
keeps the L smallest of 2L path metrics (max-log penalty update) by a
stable sort, so equal metrics go to the lower index as the reference's
top-k does; rate-0 subtrees are absorbed without branching.

CRC-aided selection: the best-metric path whose CRC checks wins; otherwise
the best-metric path is returned with ok = False.

PC codes (UCI 12 <= K <= 19, TS 38.212 §5.3.1.2): each path threads its own
length-5 cyclic register (B, L, 5).  Rate-0 subtrees rotate it by their
size; info leaves rotate by one and XOR the decided bit into slot 0 (after
the prune permutation); PC leaves force the bit to the register value and
charge the max-log penalty where the LLR disagrees.

One recursion node is a few small tensor operations, so on the card a
decode is some thousands of small launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crc import crc_check
from .code import PolarCode


def _f(a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    s = torch.sign(a1) * torch.sign(a2)
    s = torch.where(s == 0, 1.0, s)
    return s * torch.minimum(a1.abs(), a2.abs())


def _take_paths(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather the path dimension: x (B, L, ...) by idx (B, L') -> (B, L', ...)."""
    shape = (*idx.shape, *x.shape[2:])
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.ndim - 2)))
                        .expand(shape))


def _neg_part(a: torch.Tensor) -> torch.Tensor:
    """The max-log penalty of deciding 0 on LLR ``a``: -a where a < 0."""
    return torch.where(a < 0, -a, 0.0)


def decode_scl(llrs: torch.Tensor, code: PolarCode, list_size: int = 8,
               crc: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N) mother-code LLRs -> ((B, K) bits int8, (B,) ok).

    ``crc``: a name from ops.crc (e.g. 'crc11') checked over the K bits for
    CRC-aided path selection; None picks the best-metric path (ok = True)."""
    ell = list_size
    b = llrs.shape[0]
    dev = llrs.device
    frozen = np.ones(code.nof_bits, dtype=bool)
    frozen[code.info_set] = False
    pc_mask = np.zeros(code.nof_bits, dtype=bool)
    pc_mask[code.pc_set] = True

    # All L paths start identical; only path 0 is active (metric 0 against
    # +inf clones), so duplicates do not crowd out real branches.
    alpha0 = llrs.to(torch.float32)[:, None, :].expand(b, ell, code.nof_bits)
    pm0 = torch.cat([torch.zeros((b, 1), device=dev),
                     torch.full((b, ell - 1), 1e30, device=dev)], dim=1)
    id_perm = torch.arange(ell, device=dev)[None].expand(b, ell)

    def rec(alpha, pm, lo, size, reg):
        sub = frozen[lo:lo + size]
        has_pc = pc_mask[lo:lo + size].any()
        if sub.all() and not has_pc:
            # rate-0: u = 0 everywhere; a penalty for every negative LLR.
            pen = torch.sum(_neg_part(alpha), dim=-1)
            beta = torch.zeros((b, ell, size), dtype=torch.int8, device=dev)
            reg = torch.roll(reg, size % 5, dims=-1)
            return beta, beta, pm + pen, id_perm, reg
        if size == 1:
            a = alpha[..., 0]
            reg = torch.roll(reg, 1, dims=-1)
            if pc_mask[lo]:
                # PC leaf: the bit is the register value; charge the penalty
                # where the LLR disagrees.  No prune.
                ubit = reg[..., 0]                              # (B, L) int8
                pen = torch.where(ubit == 0, _neg_part(a),
                                  torch.where(a > 0, a, 0.0))
                reg = reg.clone()
                reg[..., 0] = 0                                 # y0 ^= u
                beta = ubit[..., None]
                return beta, beta, pm + pen, id_perm, reg
            # Info leaf: branch u = 0 / u = 1, keep the L best of 2L.  (Size-1
            # frozen leaves are covered by the rate-0 branch above.)
            pm2 = torch.cat([pm + _neg_part(a), pm + torch.where(a > 0, a, 0.0)],
                            dim=1)                              # (B, 2L)
            idx = torch.sort(pm2, dim=1, stable=True).indices[:, :ell]
            parent = idx % ell
            ubit = (idx // ell).to(torch.int8)
            new_pm = torch.gather(pm2, 1, idx)
            reg = _take_paths(reg, parent).clone()
            reg[..., 0] = torch.bitwise_xor(reg[..., 0], ubit)
            beta = ubit[..., None]
            return beta, beta, new_pm, parent, reg
        half = size // 2
        a1, a2 = alpha[..., :half], alpha[..., half:]
        bl, ul, pm, perm_l, reg = rec(_f(a1, a2), pm, lo, half, reg)
        a1p = _take_paths(a1, perm_l)
        a2p = _take_paths(a2, perm_l)
        ar = a2p + (1.0 - 2.0 * bl.to(torch.float32)) * a1p
        br, ur, pm, perm_r, reg = rec(ar, pm, lo + half, half, reg)
        blp = _take_paths(bl, perm_r)
        ulp = _take_paths(ul, perm_r)
        beta = torch.cat([torch.bitwise_xor(blp, br), br], dim=-1)
        u = torch.cat([ulp, ur], dim=-1)
        perm = torch.gather(perm_l, 1, perm_r)
        return beta, u, pm, perm, reg

    reg0 = torch.zeros((b, ell, 5), dtype=torch.int8, device=dev)
    _, u, pm, _, _ = rec(alpha0, pm0, 0, code.nof_bits, reg0)
    cands = u[:, :, torch.as_tensor(code.info_set, device=dev)]   # (B, L, K)
    if code.dci_interleave is not None:
        inv = np.empty(code.k, dtype=np.int64)
        inv[code.dci_interleave] = np.arange(code.k)
        cands = cands[:, :, torch.as_tensor(inv, device=dev)]

    order = torch.argsort(pm, dim=1, stable=True)                 # best first
    cands = _take_paths(cands, order)
    if crc is None:
        return cands[:, 0], torch.ones((b,), dtype=torch.bool, device=dev)
    oks = crc_check(cands.reshape(b * ell, code.k), crc).reshape(b, ell)
    any_ok = oks.any(dim=1)
    first_ok = torch.argmax(oks.to(torch.int8), dim=1)           # first True
    pick = torch.where(any_ok, first_ok, 0)
    best = torch.gather(cands, 1, pick[:, None, None].expand(b, 1, code.k))[:, 0]
    return best, any_ok
