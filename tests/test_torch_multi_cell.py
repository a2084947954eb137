"""Parity of the port's multi-carrier data plane with the JAX reference at
the small cell of tests/test_torch_slot_pipeline.py (52 PRB, nfft 768,
4 UEs x 12 PRB, 16QAM r0.4), NC = 2 carriers x S = 2 slots, each carrier
with its own RNTIs, the same numpy noise for both.

  * DL samples: within 1e-5 of the peak (FFT order; float32).
  * Scrambling inits, payloads and tb_ok: exactly equal.
  * The int8 HARQ carry: exactly equal when both back-ends get the same
    wire LLRs; from the two front-ends it may differ where the wire LLRs do
    (a float32 sum within round-off of a x.5 boundary), by at most 1, in at
    most 1e-3 of the entries, as tests/test_torch_slot_pipeline.py states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.parallel import slot_pipeline as jsp
from srsran_edgeric_5g_tpu_torch import convert
from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as tsp

torch.set_num_threads(2)
NC, S = 2, 2
RNTIS = (0x4601 + np.arange(NC * 4)).reshape(NC, 4).astype(np.uint32)


@pytest.fixture(scope="module")
def loopback():
    """Both packages' multi-cell DL and UL on the same payloads and the same
    received samples; the reference's functions are jitted once."""
    jc = jsp.CellConfig(nof_prb=52, nfft=768, nof_ue=4, prb_per_ue=12,
                        modulation="qam16", target_rate=0.4)
    tc = convert.cell_from_dict(dataclasses.asdict(jc))
    rng = np.random.default_rng(3)
    pay = rng.integers(0, 2, (NC, S, 4, jc.derived_tbs()), dtype=np.int8)
    rntis_j = jnp.asarray(RNTIS)
    td_j = np.asarray(jax.jit(lambda p: jsp.multi_cell_dl_slot_batch(
        p, rntis_j, jc))(jnp.asarray(pay)))
    td_t = tsp.multi_cell_dl_slot_batch(pay, RNTIS.astype(np.int64), tc,
                                        device="cpu")
    nv = float(np.mean(np.abs(td_j) ** 2)) * 10 ** (-20 / 10)
    noise = rng.normal(size=td_j.shape) + 1j * rng.normal(size=td_j.shape)
    rx = (td_j + noise * np.sqrt(nv / 2)).astype(np.complex64)
    ci_j = np.asarray(jsp._cell_ci(rntis_j, jc, NC, S))

    @jax.jit
    def ul_j(x):
        """The reference's multi-cell UL and the wire LLRs its front gives
        (one program)."""
        llr = jsp._ul_front(x.reshape(NC * S, -1), None, jc, ci=jnp.asarray(ci_j))[0]
        return jsp.multi_cell_ul_slot_batch(x, rntis_j, jc), llr

    res_j, llr_j = ul_j(jnp.asarray(rx))
    res_j, llr_j = [np.asarray(a) for a in res_j], np.asarray(llr_j)
    res_t = [r.numpy() for r in tsp.multi_cell_ul_slot_batch(
        rx, RNTIS.astype(np.int64), tc, device="cpu")]
    return dict(jc=jc, tc=tc, pay=pay, td_j=td_j, td_t=td_t, rx=rx, ci_j=ci_j,
                res_j=res_j, res_t=res_t, llr_j=llr_j)


def test_cell_ci_equal(loopback):
    ci_t = tsp._cell_ci(torch.as_tensor(RNTIS.astype(np.int64)), loopback["tc"], NC, S)
    assert ci_t.dtype == torch.int64 and ci_t.shape == (NC * S * 4,)
    np.testing.assert_array_equal(ci_t.numpy(), loopback["ci_j"].astype(np.int64))


def test_dl_samples(loopback):
    td_j, td_t = loopback["td_j"], loopback["td_t"]
    assert td_t.dtype == torch.complex64 and td_t.shape == td_j.shape == (
        NC, S, loopback["jc"].timing.cp.total)
    err = np.abs(td_t.numpy() - td_j).max() / np.abs(td_j).max()
    assert err < 1e-5, err


def test_ul_matches(loopback):
    (pj, okj, nvj, cfoj, softj), (pt, okt, nvt, cfot, softt) = \
        loopback["res_j"], loopback["res_t"]
    assert okj.all() and okt.shape == (NC, S, 4)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(pt, loopback["pay"])
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_allclose(nvt, nvj, rtol=1e-4)
    np.testing.assert_allclose(cfot, cfoj, atol=1e-2)
    assert softt.dtype == np.int8 and softt.shape == softj.shape
    diff = np.abs(softt.astype(int) - softj.astype(int))
    assert diff.max(initial=0) <= 1 and (diff > 0).mean() <= 1e-3


def test_ul_front_and_back_with_ci(loopback):
    """``_ul_front(ci=...)`` against the reference's on the same samples
    (the wire LLRs within one step in at most 1e-3 of entries), and the
    port's back-end on the reference's own LLRs: the reference's payload,
    tb_ok and int8 carry, bit-exact."""
    jc, tc = loopback["jc"], loopback["tc"]
    rx = torch.as_tensor(loopback["rx"]).reshape(NC * S, -1)
    llr_t = tsp._ul_front(rx, None, tc, ci=torch.as_tensor(
        loopback["ci_j"].astype(np.int64)))[0].numpy()
    llr_j = loopback["llr_j"]
    assert np.abs(llr_t - llr_j).max(initial=0) <= 1
    assert (llr_t != llr_j).mean() <= 1e-3
    pay, ok, soft = tsp._ul_back(torch.as_tensor(llr_j.reshape(NC * S * 4, -1)), tc)
    pj, okj, softj = (loopback["res_j"][i] for i in (0, 1, 4))
    np.testing.assert_array_equal(pay.numpy().reshape(pj.shape), pj)
    np.testing.assert_array_equal(ok.numpy().reshape(okj.shape), okj)
    np.testing.assert_array_equal(soft.numpy().reshape(softj.shape), softj)


def test_dl_code_ci_equals_rntis(loopback):
    """``_dl_code(ci=...)`` with the inits ``rntis`` gives is ``_dl_code(rntis)``;
    with a second carrier's inits it is the reference's symbols."""
    tc = loopback["tc"]
    pay = torch.as_tensor(loopback["pay"][0].reshape(S * 4, -1))
    rntis = torch.as_tensor(RNTIS[0].astype(np.int64))
    by_rnti = tsp._dl_code(pay, rntis, tc)
    by_ci = tsp._dl_code(pay, None, tc, ci=tsp._cell_ci(rntis[None], tc, 1, S))
    assert torch.equal(by_ci, by_rnti)
    ci1 = loopback["ci_j"][S * 4:]
    ref = np.asarray(jax.jit(lambda p, ci: jsp._dl_code(p, None, loopback["jc"], ci=ci))(
        jnp.asarray(pay.numpy()), jnp.asarray(ci1)))
    got = tsp._dl_code(pay, None, tc, ci=torch.as_tensor(ci1.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_default_device_raises_without_cuda(loopback):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tsp.multi_cell_dl_slot_batch(loopback["pay"], RNTIS.astype(np.int64),
                                     loopback["tc"])
