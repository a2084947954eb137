"""Parity of the port's SISO slot pipeline with the JAX reference at the
small cell of tests/test_slot_pipeline.py (52 PRB, nfft 768, 4 UEs x 12 PRB,
16QAM r0.4), S = 2 slots, the same numpy noise for both.

  * DL samples: rtol 1e-5 of the peak (FFT order; float32).
  * UL: payload and tb_ok exactly equal.  noise_var rtol 1e-4, cfo atol
    1e-2 Hz (an angle over 0.64 ms; float32 chains of FFT, estimator sums).
  * The int8 HARQ carry: the wire LLRs come from float32 front-ends that sum
    in different orders, so an LLR within float error of a x.5 rounding
    boundary may land one step apart.  The carry may differ only where the
    wire LLRs do, by at most 1, in at most 1e-3 of the entries; given the
    same LLRs (the back-end tests) it is exactly equal.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.parallel import slot_pipeline as jsp
from srsran_edgeric_5g_tpu_torch import convert
from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as tsp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Six test workers share the host with the JAX tests: two intra-op threads.
torch.set_num_threads(2)
S = 2
RNTIS = (0x4601 + np.arange(4)).astype(np.uint32)


def _cells():
    jc = jsp.CellConfig(nof_prb=52, nfft=768, nof_ue=4, prb_per_ue=12,
                        modulation="qam16", target_rate=0.4)
    return jc, convert.cell_from_dict(dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def loopback():
    """Both pipelines on the same payloads and the same received samples."""
    jc, tc = _cells()
    rng = np.random.default_rng(0)
    pay = rng.integers(0, 2, (S, 4, jc.derived_tbs()), dtype=np.int8)
    td_j = np.asarray(jax.jit(lambda p: jsp.dl_slot_batch(
        p, jnp.asarray(RNTIS), jc))(jnp.asarray(pay)))
    td_t = tsp.dl_slot_batch(pay, RNTIS.astype(np.int64), tc, device="cpu")
    nv = float(np.mean(np.abs(td_j) ** 2)) * 10 ** (-20 / 10)
    noise = (rng.normal(size=td_j.shape) + 1j * rng.normal(size=td_j.shape))
    rx = (td_j + noise * np.sqrt(nv / 2)).astype(np.complex64)
    ul_j = jax.jit(lambda x: jsp.ul_slot_batch(x, jnp.asarray(RNTIS), jc))
    res_j = [np.array(a) for a in ul_j(jnp.asarray(rx))]
    res_t = tsp.ul_slot_batch(rx, RNTIS.astype(np.int64), tc, device="cpu")
    llr_j = np.array(jax.jit(lambda x: jsp._ul_front(x, jnp.asarray(RNTIS), jc)[0])(
        jnp.asarray(rx)))
    llr_t = tsp._ul_front(torch.as_tensor(rx), torch.as_tensor(RNTIS.astype(np.int64)),
                          tc)[0]
    return dict(jc=jc, tc=tc, pay=pay, td_j=td_j, td_t=td_t, rx=rx,
                res_j=res_j, res_t=[r.numpy() for r in res_t],
                llr_j=llr_j, llr_t=llr_t.numpy())


def _carry_close(got, want, llr_diff):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max(initial=0) <= 1
    assert (diff > 0).sum() <= llr_diff
    assert (diff > 0).mean() <= 1e-3


def test_dl_samples(loopback):
    td_j, td_t = loopback["td_j"], loopback["td_t"]
    assert td_t.dtype == torch.complex64 and td_t.shape == td_j.shape
    err = np.abs(td_t.numpy() - td_j).max() / np.abs(td_j).max()
    assert err < 1e-5, err


def test_ul_matches(loopback):
    (pj, okj, nvj, cfoj, softj), (pt, okt, nvt, cfot, softt) = \
        loopback["res_j"], loopback["res_t"]
    assert okj.all()
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_array_equal(pt, loopback["pay"])
    np.testing.assert_allclose(nvt, nvj, rtol=1e-4)
    np.testing.assert_allclose(cfot, cfoj, atol=1e-2)
    assert softt.dtype == np.int8 and softt.shape == softj.shape
    llr_diff = int((loopback["llr_t"] != loopback["llr_j"]).sum())
    assert np.abs(loopback["llr_t"] - loopback["llr_j"]).max(initial=0) <= 1
    assert llr_diff <= 1e-3 * loopback["llr_j"].size
    _carry_close(softt, softj, llr_diff)


@pytest.mark.parametrize("new_data", [None, 0.0, 1.0])
def test_ul_back_harq_carry_exact(loopback, new_data):
    """Dematch + HARQ combine + decode + CRC on the SAME wire LLRs: payload,
    tb_ok and the int8 carry exactly equal, with and without a soft buffer
    and for both new_data settings (1 clears the carry, 0 combines)."""
    jc, tc = loopback["jc"], loopback["tc"]
    llr = loopback["llr_j"].reshape(S * 4, -1)
    soft = loopback["res_j"][4].reshape(S * 4, -1)           # (B_tb*C, n_cb)
    nd = None if new_data is None else np.full(S * 4, new_data, np.float32)
    sb_j = None if new_data is None else jnp.asarray(soft)
    out_j = jsp._ul_back(jnp.asarray(llr), jc, soft_buffer=sb_j,
                         new_data=None if nd is None else jnp.asarray(nd))
    sb_t = None if new_data is None else torch.as_tensor(soft)
    out_t = tsp._ul_back(torch.as_tensor(llr), tc, soft_buffer=sb_t,
                         new_data=None if nd is None else torch.as_tensor(nd))
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert out_t[1].all()


def test_retransmission(loopback):
    """A second reception combined into the carry the first one returned
    (ul_slot_batch with soft_buffer), through both pipelines; the reference's
    carry comes across with convert.harq_state_from_numpy."""
    jc, tc = loopback["jc"], loopback["tc"]
    rng = np.random.default_rng(5)
    td = loopback["td_j"]
    nv = float(np.mean(np.abs(td) ** 2)) * 10 ** (-3 / 10)   # a bad 3 dB retx
    rx2 = (td + (rng.normal(size=td.shape) + 1j * rng.normal(size=td.shape))
           * np.sqrt(nv / 2)).astype(np.complex64)
    soft_j = loopback["res_j"][4]
    res_j = [np.asarray(a) for a in jax.jit(lambda x, sb: jsp.ul_slot_batch(
        x, jnp.asarray(RNTIS), jc, soft_buffer=sb))(jnp.asarray(rx2),
                                                     jnp.asarray(soft_j))]
    soft_t, rntis_t = convert.harq_state_from_numpy(soft_j, RNTIS, device="cpu")
    assert soft_t.dtype == torch.int8 and rntis_t.dtype == torch.int64
    res_t = [r.numpy() for r in tsp.ul_slot_batch(rx2, rntis_t, tc,
                                                  soft_buffer=soft_t, device="cpu")]
    np.testing.assert_array_equal(res_t[0], res_j[0])
    np.testing.assert_array_equal(res_t[1], res_j[1])
    assert res_j[1].all()
    llr_j = np.asarray(jax.jit(lambda x: jsp._ul_front(
        x, jnp.asarray(RNTIS), jc)[0])(jnp.asarray(rx2)))
    llr_t = tsp._ul_front(torch.as_tensor(rx2), rntis_t, tc)[0].numpy()
    _carry_close(res_t[4], res_j[4], int((llr_t != llr_j).sum())
                 + int((loopback["llr_t"] != loopback["llr_j"]).sum()))


def test_single_slot_entry_points():
    jc, tc = _cells()
    rng = np.random.default_rng(3)
    pay = rng.integers(0, 2, (4, jc.derived_tbs()), dtype=np.int8)
    td = tsp.dl_slot(pay, RNTIS.astype(np.int64), tc, device="cpu")
    np.testing.assert_allclose(
        td.numpy(), np.asarray(jax.jit(lambda p: jsp.dl_slot(
            p, jnp.asarray(RNTIS), jc))(jnp.asarray(pay))),
        rtol=0, atol=1e-5 * float(td.abs().max()))
    p, ok, nv, cfo, soft = tsp.ul_slot(td, RNTIS.astype(np.int64), tc, device="cpu")
    assert ok.all() and torch.equal(p, torch.as_tensor(pay))
    assert nv.shape == (4,) and cfo.shape == (4,) and soft.dtype == torch.int8


def test_cell_conversion_and_unported_options():
    jc, tc = _cells()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.derived_tbs() == jc.derived_tbs()
    d = dataclasses.asdict(jc)
    d["dmrs_symbols"] = list(d["dmrs_symbols"])              # e.g. from JSON
    assert convert.cell_from_dict(d) == tc
    with pytest.raises(TypeError):
        convert.cell_from_dict({**d, "bogus": 1})
    with pytest.raises(ValueError):
        convert.harq_state_from_numpy(np.zeros((1, 4, 8), np.float32), RNTIS, "cpu")
    pay = np.zeros((1, 4, jc.derived_tbs()), np.int8)
    # The single-layer programs refuse n_layers > 1 (the *_mimo pair takes
    # it); delay_spread_us only selects the UL estimator.
    mimo = dataclasses.replace(tc, n_layers=2)
    with pytest.raises(ValueError, match="mimo"):
        tsp.dl_slot_batch(pay, RNTIS.astype(np.int64), mimo, device="cpu")
    with pytest.raises(ValueError, match="mimo"):
        tsp.ul_slot_batch(np.zeros((1, tc.timing.cp.total), np.complex64),
                          RNTIS.astype(np.int64), mimo, device="cpu")
    ta = dataclasses.replace(tc, delay_spread_us=1.0)
    assert torch.equal(tsp.dl_slot_batch(pay, RNTIS.astype(np.int64), ta, device="cpu"),
                       tsp.dl_slot_batch(pay, RNTIS.astype(np.int64), tc, device="cpu"))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default call would run")
    _, tc = _cells()
    pay = np.zeros((1, 4, tc.derived_tbs()), np.int8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsp.dl_slot_batch(pay, RNTIS.astype(np.int64), tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsp.ul_slot_batch(np.zeros((1, tc.timing.cp.total), np.complex64),
                          RNTIS.astype(np.int64), tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.harq_state_from_numpy(np.zeros((1, 4, 8), np.int8), RNTIS)


def test_port_imports_no_jax():
    """Importing every module of the port leaves JAX and the JAX package
    out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import srsran_edgeric_5g_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'srsran_edgeric_5g_tpu' or m.startswith('srsran_edgeric_5g_tpu.')]\n"
        "assert len(names) >= 17, names\n"
        "assert not bad, bad[:5]\n"
        "print(len(names))\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
