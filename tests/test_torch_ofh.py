"""The port's fronthaul (``ops/ofh_compression.py``, ``runtime/ofh.py``)
against the JAX package's on the same seeded IQ, at BFP widths 8, 9, 14
and 16 and the 'none' compression.

Quantised int16s, exponents, mantissas, packed bytes and the eCPRI frames
(through native/ofh) are compared bit for bit; decompressed floats within
1e-6 (float32 products of the same operands).  The grids hold a zero PRB,
a PRB driven into saturation and values on x.5 rounding ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.ops import ofh_compression as jofh
from srsran_edgeric_5g_tpu.runtime import ofh as jrt
from srsran_edgeric_5g_tpu_torch.ops import ofh_compression as tofh
from srsran_edgeric_5g_tpu_torch.runtime import ofh as trt

torch.set_num_threads(2)
WIDTHS = (8, 9, 14, 16)
NSYMB, NPRB = 14, 25


def _grid(seed: int, scale: float = 0.3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (NSYMB, NPRB * 12)
    g = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * scale
    g[:, :12] = 0                                     # an empty PRB
    g[0, 12:24] *= 40                                 # a saturated PRB
    g[1, 24:36] = (np.arange(12) + 0.5) / 32767       # rounding ties
    return g.astype(np.complex64)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("iq_scaling", [1.0, 0.7])
def test_bfp_stages_bit_exact(width, iq_scaling):
    g = _grid(width)
    q_j = np.asarray(jofh.quantize_iq(jnp.asarray(g), iq_scaling))
    q_t = tofh.quantize_iq(torch.as_tensor(g), iq_scaling)
    assert q_t.dtype == torch.int16
    np.testing.assert_array_equal(q_t.numpy(), q_j)
    qp = torch.as_tensor(q_j.reshape(NSYMB, NPRB, 24))
    np.testing.assert_array_equal(tofh._exponents(qp, width).numpy(),
                                  np.asarray(jofh._exponents(jnp.asarray(q_j.reshape(
                                      NSYMB, NPRB, 24)), width)))
    mant_j, exp_j = (np.asarray(a) for a in jofh.bfp_compress(jnp.asarray(g), width,
                                                               iq_scaling))
    mant_t, exp_t = tofh.bfp_compress(torch.as_tensor(g), width, iq_scaling)
    assert mant_t.dtype == torch.int16 and exp_t.dtype == torch.int32
    np.testing.assert_array_equal(mant_t.numpy(), mant_j)
    np.testing.assert_array_equal(exp_t.numpy(), exp_j)
    assert (exp_j == 0).any() and (width == 16 or exp_j.max() > 0)
    lim = 1 << (width - 1)
    assert mant_j.min() >= -lim and mant_j.max() < lim
    for sym in range(2):
        packed = tofh.pack_prbs(mant_t.numpy()[sym], width)
        np.testing.assert_array_equal(packed, jofh.pack_prbs(mant_j[sym], width))
        np.testing.assert_array_equal(tofh.unpack_prbs(packed, width),
                                      jofh.unpack_prbs(packed, width))
        np.testing.assert_array_equal(tofh.unpack_prbs(packed, width), mant_j[sym])
    dec_j = np.asarray(jofh.bfp_decompress(jnp.asarray(mant_j), jnp.asarray(exp_j)))
    dec_t = tofh.bfp_decompress(mant_t, exp_t)
    assert dec_t.dtype == torch.complex64 and dec_t.shape == g.shape
    np.testing.assert_allclose(dec_t.numpy(), dec_j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("width", WIDTHS)
def test_compression_none(width):
    g = _grid(100 + width)
    s_j = np.asarray(jofh.compress_none(jnp.asarray(g), width))
    s_t = tofh.compress_none(torch.as_tensor(g), width)
    np.testing.assert_array_equal(s_t.numpy(), s_j)
    np.testing.assert_allclose(tofh.decompress_none(s_t, width).numpy(),
                               np.asarray(jofh.decompress_none(jnp.asarray(s_j), width)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("width", WIDTHS)
def test_frames_byte_exact(width):
    """frame_dl_slot / deframe_dl_slot through native/ofh: the same frames
    as the JAX package's, back to the same decompressed grid; one frame
    also through the VLAN Ethernet wrapper."""
    g = _grid(200 + width)
    frames_j = jrt.frame_dl_slot(g, 3, 17, 4, 1, width=width, seq0=65530)
    frames_t = trt.frame_dl_slot(g, 3, 17, 4, 1, width=width, seq0=65530,
                                 device="cpu")
    assert frames_t == frames_j and len(frames_t) == NSYMB
    hdr, exps, packed = trt.parse_frame(frames_t[9], width)
    assert (hdr.pc_id, hdr.seq_id, hdr.sfn, hdr.symbol, hdr.nof_prb) == (
        3, (65530 + 9) & 0xFFFF, 17, 9, NPRB)
    back_t = trt.deframe_dl_slot(frames_t[::-1], width, device="cpu")
    np.testing.assert_allclose(back_t.numpy(), jrt.deframe_dl_slot(frames_j, width),
                               rtol=0, atol=1e-6)
    mant, exp = tofh.bfp_compress(torch.as_tensor(g), width)
    np.testing.assert_array_equal(back_t.numpy(), tofh.bfp_decompress(mant, exp).numpy())
    mac_a, mac_b = bytes(range(6)), bytes(range(6, 12))
    eth = trt.build_eth_frame(mac_a, mac_b, 7, frames_t[0])
    assert eth == jrt.build_eth_frame(mac_a, mac_b, 7, frames_j[0])
    assert trt.parse_eth_frame(eth) == (mac_a, mac_b, 7, trt.ECPRI_ETH_TYPE, frames_t[0])


def test_parse_rejects_a_short_frame():
    with pytest.raises(ValueError):
        trt.parse_frame(b"\x10\x00" * 5, 9)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        trt.frame_dl_slot(_grid(0), 0, 0, 0, 0)
