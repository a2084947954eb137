"""The check's control: the reference computed in the precision below the
configuration's float32, bfloat16.

PyTorch has no complex bfloat16, so the control keeps float32 arithmetic
inside each signal stage and rounds every tensor that crosses a stage
boundary to bfloat16 (the real and imaginary parts apart): the OFDM
modulation and demodulation, the symbol mapping and the soft demapping,
the channel estimate, the equalisers and the PRACH demodulation.  That is
a bfloat16 pipeline's storage between kernels, the step a faster program
would be tempted to take.  The GF(2) stages (CRC, polar and LDPC coding,
scrambling) stay exact, as they would in any precision.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from .ops import channel_est, equalizer, modulation, ofdm, prach

STAGES = ((ofdm, "modulate_slot"), (ofdm, "demodulate_slot"),
          (modulation, "modulate"), (modulation, "demodulate_soft"),
          (channel_est, "estimate_port"), (channel_est, "estimate_port_ta"),
          (equalizer, "equalize_mmse_1xn"),
          (equalizer, "mmse_equalize_timeinv_grid"),
          (prach, "ofdm_demodulate_prach"))


def to_bf16(x):
    """``x`` rounded to bfloat16 and back (complex parts apart); anything
    but a float or complex tensor, and nested tuples of them, as it is."""
    if isinstance(x, tuple):
        return tuple(to_bf16(v) for v in x)
    if not isinstance(x, torch.Tensor):
        return x
    if x.is_complex():
        return torch.complex(x.real.to(torch.bfloat16).float(),
                             x.imag.to(torch.bfloat16).float()).to(x.dtype)
    if x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def _rounded(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        args = tuple(to_bf16(a) for a in args)
        kwargs = {k: to_bf16(v) for k, v in kwargs.items()}
        return to_bf16(fn(*args, **kwargs))
    return wrapper


@contextlib.contextmanager
def lower_precision():
    """Within the block the reference's signal stages round their inputs
    and outputs to bfloat16."""
    saved = [(m, name, getattr(m, name)) for m, name in STAGES]
    try:
        for m, name, fn in saved:
            setattr(m, name, _rounded(fn))
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
