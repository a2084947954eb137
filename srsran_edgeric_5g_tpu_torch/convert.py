"""Carry the JAX pipeline's state into the port.

A PHY has no weights: what crosses over is the cell description (a uniform
cell, a full cell, or a per-UE grant layout with its UCI) and the HARQ state
(the pipeline's int8 carry, or the per-UE float32 soft buffers of the
heterogeneous cell).  All of it comes as plain Python / numpy values, so
this module needs nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.pdsch import PdschConfig
from .models.pusch import UciConfig
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


def pdsch_config_from_dict(d: dict) -> PdschConfig:
    """The port's PdschConfig (one UE's grant) from ``dataclasses.asdict`` of
    the reference's PdschConfig (an unknown key raises TypeError)."""
    d = dict(d)
    if "dmrs_symbols" in d:
        d["dmrs_symbols"] = tuple(int(s) for s in d["dmrs_symbols"])
    return PdschConfig(**d)


def uci_config_from_dict(d: dict) -> UciConfig:
    """The port's UciConfig from ``dataclasses.asdict`` of the reference's
    UciConfig (an unknown key raises TypeError)."""
    return UciConfig(**d)


def soft_buffers_from_numpy(buffers, device: str | torch.device = "cuda"
                            ) -> list[torch.Tensor]:
    """The heterogeneous cell's per-UE HARQ state as the port's tensors:
    each a float32 (C, N_cb) accumulated-LLR buffer, as the reference's
    ``process_*_harq_slot`` return them, kept as float32 on ``device``."""
    dev = resolve_device(device)
    out = []
    for b in buffers:
        b = np.asarray(b)
        if b.dtype != np.float32 or b.ndim != 2:
            raise ValueError(f"soft buffer must be float32 (C, N_cb), got "
                             f"{b.dtype} {b.shape}")
        out.append(torch.as_tensor(b, device=dev))
    return out
