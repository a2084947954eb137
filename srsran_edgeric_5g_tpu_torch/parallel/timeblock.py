"""Time blocks of the IQ sample stream with overlap-save halos.

Port of ``srsran_edgeric_5g_tpu/parallel/timeblock.py``.  A long stream
(many slots) is cut along its slot axis into one block per entry of a
device list.  Demodulating with a receive timing ``shift`` (every DFT
window opens ``shift`` samples before its symbol's nominal start, the
reference's nof_samples_window_offset, ofdm_demodulator_impl.cpp:60-76)
makes the first window of every block reach into the previous block's
samples: that ``shift``-sample halo is copied from each block's device to
the next block's, block 0 gets zeros (the stream's cold start), and each
block is demodulated on its own device.  The results are concatenated on
the first device.

The device list takes the place of the reference's one-axis mesh; entries
may repeat, so several blocks can share one card.  No collective library
is needed: the halo is one device-to-device copy per block.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ofdm
from ..ran.numerology import SlotTiming


def make_time_mesh(n_devices: int | None = None,
                   devices=None) -> list[torch.device]:
    """The first ``n_devices`` of ``devices`` (default: every visible CUDA
    device) as torch.devices; raises when there is none."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise RuntimeError("no device for the time mesh: no CUDA device is "
                           "visible; pass devices=['cpu'] * n for the CPU")
    return devices


def _blocks(x: torch.Tensor, mesh: list[torch.device]) -> list[torch.Tensor]:
    """The slot axis cut into len(mesh) equal blocks, block i on mesh[i]."""
    n = len(mesh)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} slots do not split into {n} blocks")
    return [b.to(d) for b, d in zip(torch.chunk(x, n, dim=0), mesh)]


def modulate_stream_sharded(grids, timing: SlotTiming, mesh: list[torch.device],
                            scale: float = 1.0) -> torch.Tensor:
    """(S, nsymb, nsubc) grids -> (S, total) samples on mesh[0]; each block
    of slots is modulated on its own device (slots are self-contained)."""
    grids = torch.as_tensor(grids)
    out = [ofdm.modulate_slot(b, timing, scale=scale)
           for b in _blocks(grids, mesh)]
    return torch.cat([o.to(mesh[0]) for o in out])


def _demod_shifted(padded_stream: torch.Tensor, timing: SlotTiming,
                   s_local: int, shift: int,
                   scale: float | None) -> torch.Tensor:
    """Demodulate ``s_local`` slots from (shift + s_local*total) samples.

    ``padded_stream[k]`` is stream sample ``k - shift`` of this block, so the
    window of symbol l in slot s (opening ``shift`` early) reads
    ``padded_stream[s*total + data_start_l : ... + nfft]``, always in range.
    The early window is corrected by the per-bin phase ramp."""
    nfft, nsubc = timing.nfft, timing.nof_subc
    dev = padded_stream.device
    starts = np.asarray(timing.cp.data_starts)
    idx = (np.arange(s_local)[:, None, None] * timing.cp.total
           + starts[None, :, None] + np.arange(nfft)[None, None, :])
    seg = padded_stream[torch.as_tensor(idx, device=dev)]      # (S, nsymb, nfft)
    fd = torch.fft.fft(seg, dim=-1).to(torch.complex64)
    sc = 1.0 / nfft if scale is None else scale
    coef = ofdm.phase_compensation(timing, 0.0, is_tx=False)
    fd = fd * torch.as_tensor(coef * np.complex64(sc), device=dev)[:, None]
    if shift:
        omega = 2.0 * np.pi * shift / nfft
        ramp = np.exp(1j * omega * np.arange(nfft)).astype(np.complex64)
        fd = fd * torch.as_tensor(ramp, device=dev)
    return fd[..., ofdm._subcarrier_bins(nsubc, nfft, dev)]


def demodulate_stream_sharded(samples, timing: SlotTiming,
                              mesh: list[torch.device], shift: int = 0,
                              scale: float | None = None) -> torch.Tensor:
    """(S, total) slot samples -> (S, nsymb, nsubc) grids on mesh[0].

    ``shift``: open every DFT window ``shift`` samples early (at most the
    shortest CP).  The first slot of each block then needs the last
    ``shift`` samples of the previous block, copied to its device; block 0
    gets zeros (the reference's ring wrap-around is dropped there too)."""
    if not 0 <= shift <= min(timing.cp.cp):
        raise ValueError(f"shift {shift} outside [0, {min(timing.cp.cp)}]")
    blocks = _blocks(torch.as_tensor(samples), mesh)
    out = []
    for i, blk in enumerate(blocks):
        flat = blk.reshape(-1)
        if i == 0:
            halo = torch.zeros(shift, dtype=flat.dtype, device=flat.device)
        else:
            prev = blocks[i - 1].reshape(-1)
            halo = prev[prev.numel() - shift:].to(flat.device)
        padded = torch.cat([halo, flat])
        out.append(_demod_shifted(padded, timing, blk.shape[0], shift, scale))
    return torch.cat([o.to(mesh[0]) for o in out])
