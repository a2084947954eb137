"""Polar rate matching / dematching (TS 38.212 §5.4.1).

Port of ``srsran_edgeric_5g_tpu/ops/polar/rate_match.py``: sub-block
interleave + puncture / shorten / repeat (+ the UCI triangular channel
interleaver) fused into one precomputed gather, and the LLR inverse with
repetition soft-combining and the neutral values of punctured (LLR 0) and
shortened (large positive LLR, known zero) positions.
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


def rate_dematch(llrs: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """(B, E) received LLRs -> (B, N) mother-code LLRs (float32).

    Repeated positions accumulate; punctured positions get 0; shortened
    positions get SHORT_LLR (the bit is known to be 0)."""
    b = llrs.shape[0]
    sel = _index_on(code, llrs.device)
    x = llrs.to(torch.float32)
    if code.rm_mode == "shorten":
        # Transmitted positions are distinct: overwrite the +inf base.
        base = torch.full((b, code.nof_bits), SHORT_LLR, dtype=torch.float32,
                          device=llrs.device)
        base[:, sel] = x
        return base
    base = torch.zeros((b, code.nof_bits), dtype=torch.float32, device=llrs.device)
    return base.index_add_(1, sel, x)
