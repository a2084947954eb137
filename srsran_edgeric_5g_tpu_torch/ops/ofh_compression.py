"""O-RAN fronthaul IQ compression: block floating point (BFP) and none.

Port of ``srsran_edgeric_5g_tpu/ops/ofh_compression.py``, the counterpart
of the reference's OFH compression stage
(srsRAN-5G-ER/lib/ofh/compression/iq_compression_bfp_impl.cpp, quantizer.h,
compressed_prb_packer.cpp): the RU downlink path compresses resource-grid
IQ into per-PRB mantissas + exponent before eCPRI framing, and decompresses
on the uplink.

Tensor side (torch, on the input's device, batched over any leading dims):
  * quantize_iq      — complex IQ in [-1, 1] -> int16 (Q = 16 quantizer:
                       scale by (2^15 - 1) * iq_scaling, round half to even
                       like the reference's SIMD cvtps path, saturate).
  * bfp_compress     — per-PRB (12 complex = 24 int16) exponent (the
                       leading-zero rule of iq_compression_bfp_impl.h:63-77)
                       + arithmetic right shift to data_width-bit mantissas.
  * bfp_decompress   — mantissas * 2^exp / (2^15 - 1) -> complex64.

Host side (numpy, the eCPRI wire format):
  * pack_prbs / unpack_prbs — MSB-first big-endian bit packing of W-bit
                       mantissas per PRB (compressed_prb_packer.cpp), one
                       udCompParam exponent byte carried separately.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_IQ_WIDTH = 16
NOF_SUBC_PER_PRB = 12
SAMPLES_PER_PRB = 2 * NOF_SUBC_PER_PRB
_GAIN = np.float32((1 << (MAX_IQ_WIDTH - 1)) - 1)  # 32767


def quantize_iq(iq: torch.Tensor, iq_scaling: float = 1.0) -> torch.Tensor:
    """Complex IQ (..., n) -> interleaved int16 (..., 2n).

    quantizer::to_fixed_point over spans (quantizer.h:66-88): x * gain *
    iq_scaling in float32, round half to even, saturate to int16."""
    x = torch.view_as_real(iq.to(torch.complex64)).reshape(*iq.shape[:-1], -1)
    scaled = torch.round(x * float(_GAIN * np.float32(iq_scaling)))
    return torch.clamp(scaled, -32768, 32767).to(torch.int16)


def _exponents(q: torch.Tensor, data_width: int) -> torch.Tensor:
    """Per-PRB BFP exponent, the reference's leading-zero rule.

    q: int16 (..., nprb, 24).  Returns int32 (..., nprb).
    max_abs = max(|max|, |min| - 1); lz_without_sign = 14 - floor(log2
    max_abs); raw = min(16 - W, lz); exp = max(0, (16 - W) - raw).  The
    floor of log2 is counted in integers (max_abs <= 2^15)."""
    max_shift = MAX_IQ_WIDTH - data_width
    maxv = q.amax(dim=-1).to(torch.int32)
    minv = q.amin(dim=-1).to(torch.int32)
    max_abs = torch.maximum(maxv.abs(), minv.abs() - 1)
    pow2 = torch.as_tensor([1 << k for k in range(1, MAX_IQ_WIDTH + 1)],
                           dtype=torch.int32, device=q.device)
    floor_log2 = (max_abs[..., None] >= pow2).sum(dim=-1, dtype=torch.int32)
    if max_shift > 0:
        lz_ws = torch.where(max_abs > 0, 14 - floor_log2, max_shift)
    else:
        lz_ws = torch.full_like(max_abs, max_shift)
    raw = torch.clamp(lz_ws, max=max_shift)
    return torch.clamp(max_shift - raw, min=0).to(torch.int32)


def bfp_compress(iq: torch.Tensor, data_width: int = 9,
                 iq_scaling: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex IQ (..., nprb*12) -> (mantissas int16 (..., nprb, 24),
    exponents int32 (..., nprb)).

    Mantissas are the data_width-bit compressed samples (sign-extended in
    int16), input_quantized >> exponent per PRB (arithmetic shift)."""
    q = quantize_iq(iq, iq_scaling)
    q = q.reshape(*q.shape[:-1], -1, SAMPLES_PER_PRB)
    exp = _exponents(q, data_width)
    mant = q.to(torch.int32) >> exp[..., None]
    return mant.to(torch.int16), exp


def bfp_decompress(mantissas: torch.Tensor, exponents: torch.Tensor
                   ) -> torch.Tensor:
    """(..., nprb, 24) int16 + (..., nprb) exponents -> complex64
    (..., nprb*12), decompress_prb_generic (mant * 2^exp / gain)."""
    scale = torch.exp2(exponents.to(torch.float32))[..., None] / float(_GAIN)
    x = mantissas.to(torch.float32) * scale
    x = x.reshape(*x.shape[:-2], -1, 2)
    return torch.complex(x[..., 0], x[..., 1])


def compress_none(iq: torch.Tensor, data_width: int = 16,
                  iq_scaling: float = 1.0) -> torch.Tensor:
    """'none' compression (iq_compression_none_impl): plain quantization to
    data_width-bit samples (stored sign-extended in int16)."""
    q = quantize_iq(iq, iq_scaling).to(torch.int32)
    return (q >> (MAX_IQ_WIDTH - data_width)).to(torch.int16)


def decompress_none(samples: torch.Tensor, data_width: int = 16) -> torch.Tensor:
    gain = float(np.float32((1 << (data_width - 1)) - 1))
    x = samples.to(torch.float32) / gain
    x = x.reshape(*x.shape[:-1], -1, 2)
    return torch.complex(x[..., 0], x[..., 1])


# ---------------------------------------------------------------------------
# Host-side wire format (eCPRI U-plane PRB payload).
# ---------------------------------------------------------------------------

def pack_prbs(mantissas: np.ndarray, data_width: int) -> np.ndarray:
    """(nprb, 24) int16 W-bit mantissas -> (nprb, ceil(24W/8)) packed bytes.

    MSB-first concatenation of the W low bits of each sample, zero tail
    padding (compressed_prb_packer.cpp:28-61)."""
    nprb = mantissas.shape[0]
    u = mantissas.astype(np.int64) & ((1 << data_width) - 1)
    shifts = np.arange(data_width - 1, -1, -1)
    bits = ((u[..., None] >> shifts) & 1).astype(np.uint8).reshape(nprb, -1)
    pad = (-bits.shape[1]) % 8
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    return np.packbits(bits, axis=1)


def unpack_prbs(packed: np.ndarray, data_width: int) -> np.ndarray:
    """(nprb, nbytes) packed bytes -> (nprb, 24) sign-extended int16."""
    nprb = packed.shape[0]
    bits = np.unpackbits(packed, axis=1)[:, :SAMPLES_PER_PRB * data_width]
    bits = bits.reshape(nprb, SAMPLES_PER_PRB, data_width).astype(np.int64)
    weights = 1 << np.arange(data_width - 1, -1, -1)
    u = (bits * weights).sum(axis=-1)
    sign = 1 << (data_width - 1)
    return (u - 2 * (u & sign)).astype(np.int16)
