"""Device selection for the port's public entry points, and host constants
kept on the device."""

from __future__ import annotations

import numpy as np
import torch

from .utils.tracing import cached_build


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a torch.device; a CUDA request on a host without a
    CUDA device raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain CPU versions")
    return dev


def host_constant(values, device: torch.device) -> torch.Tensor:
    """A numpy constant (or a sequence, such as a list of symbol indices)
    as a tensor on ``device``, copied there once per value.  A step that
    built it anew would copy it from pageable host memory every call, and
    that copy waits for the device; the returned tensor is shared, so
    callers only read it."""
    arr = np.ascontiguousarray(values)
    return _host_constant(arr.dtype.str, arr.shape, arr.tobytes(),
                          torch.device(device))


@cached_build
def _host_constant(dtype: str, shape: tuple, data: bytes,
                   device: torch.device) -> torch.Tensor:
    arr = np.frombuffer(data, dtype=dtype).reshape(shape)
    return torch.as_tensor(arr.copy(), device=device)
