"""Carry the JAX pipeline's state into the port.

A PHY has no weights: what crosses over is the cell description and the
HARQ state.  Both come as plain Python / numpy values, so this module needs
nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .parallel.full_cell import FullCellConfig
from .parallel.slot_pipeline import CellConfig


def cell_from_dict(d: dict) -> CellConfig:
    """The port's CellConfig from ``dataclasses.asdict`` of the reference's
    CellConfig (a plain dict; an unknown key raises TypeError)."""
    d = dict(d)
    if "dmrs_symbols" in d:
        d["dmrs_symbols"] = tuple(int(s) for s in d["dmrs_symbols"])
    return CellConfig(**d)


def full_cell_from_dict(d: dict) -> FullCellConfig:
    """The port's FullCellConfig from ``dataclasses.asdict`` of the
    reference's FullCellConfig (an unknown key raises TypeError)."""
    return FullCellConfig(**d)


def harq_state_from_numpy(soft, rntis, device: str | torch.device = "cuda"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference pipeline's HARQ state as the port's tensors.

    ``soft``: int8 soft buffers as its ``ul_slot_batch`` /
    ``gnb_ul_slot_batch`` return them, in the (S, U*C, n_cb) layout or the
    flat (S*U*C, n_cb) one (``soft_flat``); the layout is kept.  ``rntis``:
    (U,) RNTIs.  Returns (soft int8, rntis int64) on ``device``."""
    soft = np.asarray(soft)
    if soft.dtype != np.int8 or soft.ndim not in (2, 3):
        raise ValueError(f"soft buffer must be int8 (S, U*C, n_cb) or "
                         f"(S*U*C, n_cb), got {soft.dtype} {soft.shape}")
    dev = resolve_device(device)
    return (torch.as_tensor(soft, device=dev),
            torch.as_tensor(np.asarray(rntis).astype(np.int64), device=dev))
