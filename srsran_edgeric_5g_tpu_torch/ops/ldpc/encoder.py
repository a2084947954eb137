"""LDPC encoder: lifted base-graph encode as edge gathers + GF(2) matmuls.

Port of the ``gather`` form of ``srsran_edgeric_5g_tpu/ops/ldpc/encoder.py``
(TS 38.212 §5.3.2):

  1. one gather of all rotated message blocks (edge list from the plan),
  2. a (rows x E) selector matmul accumulating check-row sums,
  3. a dense (4Zc x 4Zc) GF(2) solve for the core parities, as a
     precomputed inverse applied by a batched matmul,
  4. one more gather + matmul for the extension parities.

Batched over codeblocks; the encoder emits the full cols*Zc codeword
(including the 2*Zc punctured systematic bits).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...utils.bits import parity_dot
from .graph import get_graph, gf2_inv


@dataclasses.dataclass(frozen=True, eq=False)
class EncodePlan:
    bg: int
    zc: int
    idx_msg: torch.Tensor       # (E_msg, Zc) gather into flat message (K,)
    sel_msg: torch.Tensor       # (rows, E_msg) row selector, float32
    core_inv_t: torch.Tensor    # (4Zc, 4Zc): p_core = s_core @ core_inv_t
    idx_core_ext: torch.Tensor  # (E_ce, Zc) gather into flat p_core (4Zc,)
    sel_core_ext: torch.Tensor  # (rows-4, E_ce) float32


@functools.lru_cache(maxsize=None)
def get_encode_plan(bg: int, zc: int, device: torch.device) -> EncodePlan:
    g = get_graph(bg, zc)
    z = np.arange(zc)

    msg = g.edge_col < g.kb
    core = (g.edge_col >= g.kb) & (g.edge_col < g.kb + 4)
    ext_parity = g.edge_col >= g.kb + 4
    # Base-graph structure the solve relies on: extension rows have exactly
    # one degree-1 parity column with shift 0 on the diagonal, and the core
    # rows touch only message + core parity columns.
    er, ec, es = g.edge_row[ext_parity], g.edge_col[ext_parity], g.edge_shift[ext_parity]
    if not ((ec == g.kb + er).all() and (es == 0).all() and len(er) == g.rows - 4
            and (g.edge_col[g.edge_row < 4] < g.kb + 4).all()):
        raise ValueError(f"BG{bg} Zc={zc}: unexpected base-graph structure")

    idx_msg = np.stack([c * zc + (z + s) % zc
                        for c, s in zip(g.edge_col[msg], g.edge_shift[msg])])
    sel_msg = np.zeros((g.rows, msg.sum()), dtype=np.float32)
    sel_msg[g.edge_row[msg], np.arange(msg.sum())] = 1

    a = np.zeros((4 * zc, 4 * zc), dtype=np.uint8)
    for r, c, s in zip(g.edge_row[core], g.edge_col[core], g.edge_shift[core]):
        if r < 4:
            a[r * zc + z, (c - g.kb) * zc + (z + s) % zc] ^= 1
    core_inv_t = gf2_inv(a).T.astype(np.float32)

    ce = core & (g.edge_row >= 4)
    idx_core_ext = np.stack([(c - g.kb) * zc + (z + s) % zc
                             for c, s in zip(g.edge_col[ce], g.edge_shift[ce])])
    sel_core_ext = np.zeros((g.rows - 4, ce.sum()), dtype=np.float32)
    sel_core_ext[g.edge_row[ce] - 4, np.arange(ce.sum())] = 1

    def t(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return EncodePlan(bg=bg, zc=zc,
                      idx_msg=t(idx_msg, torch.int64),
                      sel_msg=t(sel_msg, torch.float32),
                      core_inv_t=t(core_inv_t, torch.float32),
                      idx_core_ext=t(idx_core_ext, torch.int64),
                      sel_core_ext=t(sel_core_ext, torch.float32))


def _row_sums(flat_bits: torch.Tensor, idx: torch.Tensor,
              sel: torch.Tensor) -> torch.Tensor:
    """(B, nbits) -> (B, rows, Zc) real-valued row accumulations (pre mod-2):
    gather every rotated edge block, then reduce edges per check row with a
    selector matmul (exact: integer sums far below 2**24)."""
    e, zc = idx.shape
    rot = flat_bits[:, idx.reshape(-1)].reshape(-1, e, zc).to(torch.float32)
    return torch.matmul(sel, rot)


_IMPLS = ("auto", "gather", "rolls")


def encode(msg_bits: torch.Tensor, bg: int, zc: int,
           impl: str = "auto") -> torch.Tensor:
    """Encode int8 {0,1} messages (B, K=kb*Zc) -> full codewords (B, cols*Zc).

    Filler bits must already be zero in ``msg_bits`` (the segmenter sets
    them); they encode as zeros and are handled by rate matching.

    ``impl`` takes the reference's names, and every one is the gather form
    here: the reference's 'rolls' (lane rotations + XORs, its TPU path)
    computes the same codeword, and 'auto' picks between the two by
    backend."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown encoder impl {impl!r}; valid: {_IMPLS}")
    plan = get_encode_plan(bg, zc, msg_bits.device)
    b = msg_bits.shape[0]

    m = msg_bits.reshape(b, -1).to(torch.int8)
    s_all = torch.remainder(_row_sums(m, plan.idx_msg, plan.sel_msg), 2.0)

    s_core = s_all[:, :4].reshape(b, 4 * zc)
    p_core = parity_dot(s_core, plan.core_inv_t)                   # (B, 4Zc)

    s_ext = _row_sums(p_core, plan.idx_core_ext, plan.sel_core_ext)
    p_ext = torch.remainder(s_all[:, 4:] + s_ext, 2.0).to(torch.int8)

    return torch.cat([m, p_core, p_ext.reshape(b, -1)], dim=-1)
