"""Polar rate matching (TS 38.212 §5.4.1): sub-block interleave + puncture
/ shorten / repeat (+ the UCI triangular channel interleaver) fused into
one precomputed gather.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .code import PolarCode

SHORT_LLR = 1e9  # effectively-infinite positive LLR for shortened bits


@functools.lru_cache(maxsize=None)
def triangular_interleave(e: int) -> np.ndarray:
    """TS 38.212 §5.4.1.3 coded-bit interleaver (i_BIL = 1): perm with
    f[i] = e[perm[i]] — write row-wise into a triangle of T rows, read
    column-wise."""
    t = 1
    while t * (t + 1) // 2 < e:
        t += 1
    out = []
    for r in range(t):
        i_in = r
        for c in range(t - r):
            if i_in >= e:
                break
            out.append(i_in)
            i_in += t - c
    perm = np.asarray(out, dtype=np.int64)
    assert len(perm) == e
    return perm


@functools.lru_cache(maxsize=None)
def select_index(code: PolarCode) -> np.ndarray:
    """Output position -> mother-codeword index."""
    jn = code.subblock_perm
    nb, e = code.nof_bits, code.e
    if code.rm_mode == "repeat":
        sel = jn[np.arange(e) % nb]
    elif code.rm_mode == "puncture":
        sel = jn[nb - e:]
    else:
        sel = jn[:e]  # shorten
    if code.i_bil:
        sel = sel[triangular_interleave(e)]
    return sel


@functools.lru_cache(maxsize=None)
def _index_on(code: PolarCode, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(select_index(code), device=device)


def rate_match(codeword: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """(B, N) mother codeword -> (B, E) transmitted bits."""
    return codeword[:, _index_on(code, codeword.device)]

