"""Parity of the port's LDPC codec with the JAX reference: segmentation,
encoding, rate (de)matching and the layered decode schedules.

Bit-exact throughout: segmentation / encoding / rate matching are integer
and GF(2) maps; the wire-domain dematch combines integers (exact in bf16 and
float32); the decoders repeat the reference's float32 operation sequence
('layered') or its integer-valued wire arithmetic ('layered_wire')."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.ops.ldpc import decoder as jdec
from srsran_edgeric_5g_tpu.ops.ldpc import encoder as jenc
from srsran_edgeric_5g_tpu.ops.ldpc import rate_match as jrm
from srsran_edgeric_5g_tpu.ops.ldpc import segmenter as jseg
from srsran_edgeric_5g_tpu.ops.ldpc.graph import get_graph
from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder as tdec
from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder_cuda as tdc
from srsran_edgeric_5g_tpu_torch.ops.ldpc import encoder as tenc
from srsran_edgeric_5g_tpu_torch.ops.ldpc import rate_match as trm
from srsran_edgeric_5g_tpu_torch.ops.ldpc import segmenter as tseg

# Six test workers share the host with the JAX tests: two intra-op threads.
torch.set_num_threads(2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("a,rate,g_total,qm", [
    (200, 0.3, 1200, 2), (2408, 0.4, 5760, 4), (9224, 0.5, 18720, 6),
    (30000, 0.8, 37440, 8), (3000, 0.2, 15000, 2)])
def test_segment_desegment(a, rate, g_total, qm):
    bg = jseg.select_base_graph(a, rate)
    assert tseg.select_base_graph(a, rate) == bg
    pj = jseg.get_segment_plan(a, bg, g_total, qm)
    pt = tseg.get_segment_plan(a, bg, g_total, qm)
    for f in ("bg", "a", "c", "zc", "k", "k_prime", "tb_crc", "cb_crc", "e"):
        assert getattr(pj, f) == getattr(pt, f), f
    rng = np.random.default_rng(a)
    pay = rng.integers(0, 2, (3, a), dtype=np.int8)
    cbs_j = np.asarray(jseg.segment_tb(jnp.asarray(pay), pj))
    cbs_t = tseg.segment_tb(torch.as_tensor(pay), pt).numpy()
    np.testing.assert_array_equal(cbs_t, cbs_j)
    bad = cbs_t.copy()
    bad[0, 5] ^= 1                                   # corrupt TB 0
    bad[-pt.c:] = 0                                  # all-zero decode of TB 2
    for x in (cbs_t, bad):
        pj_out = jseg.desegment_tb(jnp.asarray(x), pj)
        pt_out = tseg.desegment_tb(torch.as_tensor(x), pt)
        for u, v in zip(pt_out, pj_out):
            np.testing.assert_array_equal(_np(u), _np(v))
    assert tseg.desegment_tb(torch.as_tensor(bad), pt)[1].tolist() == [False, True, False]


@pytest.mark.parametrize("bg", [1, 2])
@pytest.mark.parametrize("zc", [2, 15, 64, 128, 224, 384])
def test_encode(bg, zc):
    g = get_graph(bg, zc)
    rng = np.random.default_rng(bg * 1000 + zc)
    msgs = rng.integers(0, 2, (4, g.k), dtype=np.int8)
    np.testing.assert_array_equal(
        tenc.encode(torch.as_tensor(msgs), bg, zc).numpy(),
        np.asarray(jenc.encode(jnp.asarray(msgs), bg, zc, impl="gather")))


@pytest.mark.parametrize("bg,zc,e,qm,k_prime,n_cb", [
    (1, 224, 9360, 6, 4648, None), (2, 256, 5760, 4, 2424, None),
    (2, 64, 1600, 2, 500, None),     # E > N_cb: wraps repeat positions
    (1, 128, 4000, 8, 2000, 5000)])  # limited buffer
@pytest.mark.parametrize("rv", [0, 1, 2, 3])
def test_rate_match_dematch(bg, zc, e, qm, k_prime, n_cb, rv):
    pj = jrm.get_rate_match_plan(bg, zc, e, rv, qm, k_prime, n_cb)
    pt = trm.get_rate_match_plan(bg, zc, e, rv, qm, k_prime, n_cb)
    assert pt.n_cb == pj.n_cb
    np.testing.assert_array_equal(pt.select_idx, pj.select_idx)
    g = get_graph(bg, zc)
    rng = np.random.default_rng(e + rv)
    cw = rng.integers(0, 2, (3, g.n_full), dtype=np.int8)
    np.testing.assert_array_equal(
        trm.rate_match(torch.as_tensor(cw), pt).numpy(),
        np.asarray(jrm.rate_match(jnp.asarray(cw), pj)))
    # Wire-domain LLRs (integers) and an int8 HARQ carry near saturation.
    llr = rng.integers(-120, 121, (3, e)).astype(np.float32)
    soft = rng.integers(-127, 128, (3, pt.n_cb)).astype(np.int8)
    for sb in (None, soft):
        for dt_j, dt_t, sat in ((jnp.bfloat16, torch.bfloat16, True),
                                (jnp.float32, torch.float32, False)):
            want = jrm.rate_dematch(jnp.asarray(llr), pj,
                                    None if sb is None else jnp.asarray(sb),
                                    dtype=dt_j, saturate=sat)
            got = trm.rate_dematch(torch.as_tensor(llr), pt,
                                   None if sb is None else torch.as_tensor(sb),
                                   dtype=dt_t, saturate=sat)
            assert got.dtype == dt_t
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, dtype=np.float32))


def _awgn_llrs(bg, zc, b, snr_db, seed):
    g = get_graph(bg, zc)
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (b, g.k), dtype=np.int8)
    cw = tenc.encode(torch.as_tensor(msgs), bg, zc).numpy()
    sigma = 10 ** (-snr_db / 20)
    y = 1 - 2 * cw[:, 2 * zc:].astype(np.float32) + rng.normal(size=(b, g.n_full - 2 * zc)) * sigma
    llr = np.concatenate([np.zeros((b, 2 * zc)), 2 * y / sigma ** 2], 1).astype(np.float32)
    wire = np.clip(np.round(np.clip(llr, -20, 20) * 6.0), -120, 120).astype(np.float32)
    return msgs, llr, wire


@pytest.mark.parametrize("bg", [1, 2])
@pytest.mark.parametrize("zc", [64, 128, 224])
@pytest.mark.parametrize("schedule", ["layered", "layered_wire"])
@pytest.mark.parametrize("early_stop", [False, True])
def test_decode_schedules(bg, zc, schedule, early_stop):
    """Hard bits and ok bit-exact, at an SNR where some codeblocks fail (so
    the early-stop loop runs its full count on part of the batch)."""
    _, llr, wire = _awgn_llrs(bg, zc, 3, snr_db=0.8, seed=bg * 10 + zc)
    x = wire if schedule == "layered_wire" else llr
    iters = 2 + (zc % 3)
    hj, okj = jdec.decode(jnp.asarray(x), bg, zc, num_iters=iters,
                          schedule=schedule, early_stop=early_stop)
    ht, okt = tdec.decode(torch.as_tensor(x), bg, zc, num_iters=iters,
                          schedule=schedule, early_stop=early_stop)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


@pytest.mark.parametrize("scale_floor", [False, True])
def test_minsum_ties(scale_floor):
    """Equal magnitudes: the first minimum (lowest index) gets m2 == m1 —
    torch.argmin and jnp.argmin both return the first of equal minima."""
    t = np.array([[[3.0, -3.0, 5.0, 3.0, -7.0]],
                  [[-2.0, 2.0, -2.0, 2.0, 9.0]],
                  [[121.0, -127.0, 50.0, 50.0, -50.0]],
                  [[0.0, -0.0, 4.0, 4.0, 1.0]]], np.float32).transpose(0, 2, 1)
    mask = np.array([True, True, True, True, False])[None, :, None]
    for m in (None, mask):
        want = jdec._minsum(jnp.asarray(t), jnp.asarray(True if m is None else m),
                            0.8, deg_axis=1, scale_floor=scale_floor)
        got = tdec._minsum(torch.as_tensor(t), None if m is None else torch.as_tensor(m),
                           0.8, deg_axis=1, scale_floor=scale_floor)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_with_ties():
    """A whole decode on integer LLRs full of equal magnitudes."""
    bg, zc = 2, 64
    msgs, _, _ = _awgn_llrs(bg, zc, 2, 3.0, seed=4)
    cw = tenc.encode(torch.as_tensor(msgs), bg, zc).numpy()
    x = (1 - 2 * cw.astype(np.float32)) * 4.0
    x[:, :2 * zc] = 0.0
    x[:, 2 * zc::7] *= -1.0                          # flipped, equally confident
    for schedule in ("layered", "layered_wire"):
        hj, okj = jdec.decode(jnp.asarray(x), bg, zc, num_iters=3,
                              schedule=schedule, early_stop=False)
        ht, okt = tdec.decode(torch.as_tensor(x), bg, zc, num_iters=3,
                              schedule=schedule, early_stop=False)
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


def test_check_parity():
    bg, zc = 1, 64
    msgs, _, _ = _awgn_llrs(bg, zc, 3, 3.0, seed=6)
    cw = tenc.encode(torch.as_tensor(msgs), bg, zc).numpy()
    cw[1, 100] ^= 1
    np.testing.assert_array_equal(
        tdec.check_parity(torch.as_tensor(cw), bg, zc).numpy(),
        np.asarray(jdec.check_parity(jnp.asarray(cw), bg, zc)))
    assert tdec.check_parity(torch.as_tensor(cw), bg, zc).tolist() == [True, False, True]


def test_decode_dispatch():
    """wire_auto on a CPU tensor is layered_wire, auto is layered; pallas is
    the kernel's f32 plain version; unported schedules raise
    NotImplementedError."""
    bg, zc = 2, 128
    msgs, llr, wire = _awgn_llrs(bg, zc, 4, 2.0, seed=3)
    a = tdec.decode(torch.as_tensor(wire), bg, zc, schedule="wire_auto")
    b = tdec.decode(torch.as_tensor(wire), bg, zc, schedule="layered_wire")
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    hp, okp = tdec.decode(torch.as_tensor(llr), bg, zc, num_iters=4, schedule="pallas")
    hk, okk, _ = tdc.decode_layered(torch.as_tensor(llr), bg, zc, num_iters=4)
    assert torch.equal(hp, hk) and torch.equal(okp, okk)
    np.testing.assert_array_equal(hp.numpy(), msgs)
    for u, v in zip(tdec.decode(torch.as_tensor(llr), bg, zc, schedule="auto"),
                    tdec.decode(torch.as_tensor(llr), bg, zc, schedule="layered")):
        assert torch.equal(u, v)
    for name in ("flooding", "layered_rolls_wire", "layered_rolls_i8"):
        with pytest.raises(NotImplementedError):
            tdec.decode(torch.as_tensor(llr), bg, zc, schedule=name)
    with pytest.raises(ValueError):
        tdec.decode(torch.as_tensor(llr), bg, zc, schedule="nope")
