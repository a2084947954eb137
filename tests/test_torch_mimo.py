"""Parity of the port's multi-layer data plane with the JAX reference: the
equaliser (ops/equalizer.py), the slot pipeline's *_mimo programs and the
MIMO full gNB slot, on the same numpy-seeded inputs.

  * Equaliser functions on random well-conditioned inputs, L in {1, 2, 4}
    (L = 3 through the general linalg.inv branch of mmse_weights_lxn and
    equalize_mmse_lxn), P in {2, 4}: every output within rtol 1e-4 of its
    peak (float32 closed-form inverses; complex products in another order).
  * dl/ul_slot_batch_mimo at L = 2 and 4 on a small cell (52 PRB, 2 UEs x
    20 PRB, 16QAM r0.5, S = 2) through tests/test_full_cell_mimo.py's LxL
    spatial channel at 25 dB.
  * The full cell at tests/test_full_cell_mimo.py's small_fc(2) and
    small_fc(4), S = 6 (SSB, CSI, SRS and PRACH occasions all present),
    and a chase-combined second reception through the reference's carry.
  * What must match: payload, tb_ok, the int8 carry, ACK bits, CSI bits,
    csi_ok, PRACH detection and delay are equal; DL samples within 1e-5 of
    the peak; floats within rtol 1e-4 of the peak; cfo within 1e-2 Hz.
    The wire LLRs come from float32 fronts that sum in other orders, so a
    ±1 wire-LLR step is allowed in at most 1e-3 of the entries, and the
    carry may differ only there (as tests/test_torch_slot_pipeline.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.ops import equalizer as jeq
from srsran_edgeric_5g_tpu.ops.ldpc import decoder as jdec
from srsran_edgeric_5g_tpu.ops.ldpc import rate_match as jrm
from srsran_edgeric_5g_tpu.ops.ldpc import segmenter as jseg
from srsran_edgeric_5g_tpu.parallel import full_cell as jfc
from srsran_edgeric_5g_tpu.parallel import slot_pipeline as jsp
from srsran_edgeric_5g_tpu_torch import convert
from srsran_edgeric_5g_tpu_torch.ops import equalizer as teq
from srsran_edgeric_5g_tpu_torch.parallel import full_cell as tfc
from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as tsp

# Six test workers share the host with the JAX tests: two intra-op threads.
torch.set_num_threads(2)

RTOL = 1e-4
S_FC = 6
EXACT = ("payload", "tb_ok", "ack_bits", "csi_bits", "csi_ok",
         "prach_detected", "prach_delay")
CLOSE = ("noise_var", "srs_h", "srs_snr_db", "ack_metric", "prach_metric")


def _close(got, want, rtol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.resolve_conj().numpy()
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _cplx(rng, *shape):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape))
            / np.sqrt(2)).astype(np.complex64)


def _mix_matrix(rng, n):
    """tests/test_full_cell_mimo.py's well-conditioned LxL channel."""
    a = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))) / np.sqrt(2)
    f = np.exp(-2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n)
    return (0.35 * a + f / np.sqrt(n)).astype(np.complex64)


def _channel(rng, p, n_l, *batch):
    """(P, L, *batch) channel: the mixing matrix plus a small per-RE part."""
    return (_mix_matrix(rng, max(p, n_l))[:p, :n_l].reshape(p, n_l, *([1] * len(batch)))
            + 0.2 * _cplx(rng, p, n_l, *batch)).astype(np.complex64)


def _awgn(x, snr_db, rng):
    nv = float((np.abs(x) ** 2).mean()) * 10 ** (-snr_db / 10)
    noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    return (x + noise * np.sqrt(nv / 2)).astype(np.complex64)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ================================================================ equaliser

@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("n_l", [1, 2, 3, 4])
def test_equalize_mmse_lxn_and_weights(n_l, p):
    rng = np.random.default_rng(10 * n_l + p)
    h = _channel(rng, p, n_l, 3, 40)
    y = _cplx(rng, p, 3, 40)
    nv = rng.uniform(0.02, 0.1, size=(p, 1, 1)).astype(np.float32)
    want = jax.jit(jeq.equalize_mmse_lxn)(jnp.asarray(y), jnp.asarray(h), jnp.asarray(nv))
    got = teq.equalize_mmse_lxn(_t(y), _t(h), _t(nv))
    assert got[0].dtype == torch.complex64 and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        _close(g, w)
    want = jax.jit(jeq.mmse_weights_lxn)(jnp.asarray(h), jnp.asarray(nv))
    got = teq.mmse_weights_lxn(_t(h), _t(nv))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("n_l", [1, 2, 4])
def test_binv_and_timeinv(n_l, p):
    """_binv_scalars, mmse_equalize_timeinv and its grid-layout twin."""
    rng = np.random.default_rng(100 * n_l + p)
    h = _channel(rng, p, n_l, 3, 24)                   # (P, L, B, w)
    hw = h / rng.uniform(0.02, 0.1, size=(p, 1, 1, 1)).astype(np.float32)
    binv_j, g_j = jax.jit(jeq._binv_scalars, static_argnums=2)(
        jnp.asarray(h), jnp.asarray(hw), n_l)
    binv_t, g_t = teq._binv_scalars(_t(h), _t(hw), n_l)
    assert sorted(binv_t) == sorted(binv_j)
    for key in binv_j:
        _close(binv_t[key], binv_j[key])
    for g, w in zip(g_t, g_j):
        _close(g, w)

    y = _cplx(rng, p, 3, 5, 24)                        # (P, B, n, w)
    nv = rng.uniform(0.02, 0.1, size=(p, 3, 1)).astype(np.float32)
    want = jax.jit(jeq.mmse_equalize_timeinv)(jnp.asarray(y), jnp.asarray(h),
                                              jnp.asarray(nv))
    got = teq.mmse_equalize_timeinv(_t(y), _t(h), _t(nv))
    for g, w in zip(got, want):
        _close(g, w)

    hg = _channel(rng, p, n_l, 2, 3, 24).transpose(2, 0, 1, 3, 4)   # (S, P, L, U, w)
    yg = _cplx(rng, 2, p, 5, 3, 24)                                  # (S, P, n, U, w)
    nvg = rng.uniform(0.02, 0.1, size=(2, p, 3, 1)).astype(np.float32)
    want = jax.jit(jeq.mmse_equalize_timeinv_grid)(jnp.asarray(yg), jnp.asarray(hg),
                                                   jnp.asarray(nvg))
    got = teq.mmse_equalize_timeinv_grid(_t(yg), _t(hg), _t(nvg))
    assert got[0].shape == (2, 5, 3, 24, n_l) and got[1].shape == (2, 3, 24, n_l)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("n_l", [1, 2, 3, 4])
def test_inv_small(n_l):
    """_inv_small (and _inv2 inside it) on Hermitian PD A + I."""
    rng = np.random.default_rng(n_l)
    m = _cplx(rng, 7, 5, n_l, n_l)
    b = (np.einsum("...ji,...jk->...ik", m.conj(), m)
         + np.eye(n_l, dtype=np.complex64)).astype(np.complex64)
    want = np.asarray(jax.jit(jeq._inv_small)(jnp.asarray(b)))
    got = teq._inv_small(_t(b)).numpy()
    _close(got, want)
    _close(got @ b, np.broadcast_to(np.eye(n_l), b.shape), rtol=1e-4)


@pytest.mark.parametrize("p", [2, 4])
def test_equalize_mmse_2xn_and_zf(p):
    rng = np.random.default_rng(p)
    h = _channel(rng, p, 2, 4, 30)
    y = _cplx(rng, p, 4, 30)
    nv = rng.uniform(0.02, 0.1, size=(p, 1, 1)).astype(np.float32)
    want = jax.jit(jeq.equalize_mmse_2xn)(jnp.asarray(y), jnp.asarray(h), jnp.asarray(nv))
    got = teq.equalize_mmse_2xn(_t(y), _t(h), _t(nv))
    for g, w in zip(got, want):
        _close(g, w)
    h1 = h[:, 0].copy()
    h1[0, 0, :3] = 0                                   # a port excluded there
    want = jax.jit(jeq.equalize_zf_1xn)(jnp.asarray(y), jnp.asarray(h1), jnp.asarray(nv))
    got = teq.equalize_zf_1xn(_t(y), _t(h1), _t(nv))
    for g, w in zip(got, want):
        _close(g, w)


# ======================================================== slot pipeline

def _small_cell(n_l):
    jc = jsp.CellConfig(nof_prb=52, nfft=768, nof_ue=2, prb_per_ue=20,
                        modulation="qam16", target_rate=0.5, n_layers=n_l)
    return jc, convert.cell_from_dict(dataclasses.asdict(jc))


def _carry_close(got, want, llr_diff):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max(initial=0) <= 1
    assert (diff > 0).sum() <= llr_diff
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("n_l", [2, 4])
def test_slot_batch_mimo(n_l):
    """DL samples, then both receivers on one mixed, noisy rx: the wire
    LLRs, the decode, and a chase-combined second reception."""
    jc, tc = _small_cell(n_l)
    assert tc.n_layers == n_l and tc.derived_tbs() == jc.derived_tbs()
    rng = np.random.default_rng(n_l)
    s = 2
    rn = (0x4601 + np.arange(2)).astype(np.uint32)
    pay = rng.integers(0, 2, (s, 2, jc.derived_tbs()), dtype=np.int8)
    td_j = np.asarray(jax.jit(lambda p: jsp.dl_slot_batch_mimo(
        p, jnp.asarray(rn), jc))(jnp.asarray(pay)))
    td_t = tsp.dl_slot_batch_mimo(pay, rn.astype(np.int64), tc, device="cpu")
    assert td_t.shape == (s, n_l, tc.timing.cp.total)
    assert np.abs(td_t.numpy() - td_j).max() <= 1e-5 * np.abs(td_j).max()

    rx = _awgn(np.einsum("pl,slt->spt", _mix_matrix(rng, n_l), td_j), 25.0, rng)

    @jax.jit
    def ul_j(x, sb, nd):
        """The reference's receiver and its wire LLRs, one program for both
        receptions: the first one through a zero carry that new_data = 1
        clears, which is the receiver without a carry."""
        return (jsp.ul_slot_batch_mimo(x, jnp.asarray(rn), jc, soft_buffer=sb,
                                       new_data=nd),
                jsp._ul_front_mimo(x, jnp.asarray(rn), jc)[0])

    seg_j, rm_j = jsp._plans(jc)
    zero = jnp.zeros((s, 2 * seg_j.c, rm_j.n_cb), jnp.int8)
    res_j, llr_j = ul_j(jnp.asarray(rx), zero, jnp.ones((s, 2), jnp.float32))
    res_j, llr_j = [np.asarray(a) for a in res_j], np.asarray(llr_j)
    res_t = [a.numpy() for a in tsp.ul_slot_batch_mimo(rx, rn.astype(np.int64), tc,
                                                       device="cpu")]
    assert res_j[1].all() and (res_j[0] == pay).all()
    np.testing.assert_array_equal(res_t[0], res_j[0])
    np.testing.assert_array_equal(res_t[1], res_j[1])
    _close(res_t[2], res_j[2])
    np.testing.assert_allclose(res_t[3], res_j[3], atol=1e-2)
    llr_t = tsp._ul_front_mimo(_t(rx), _t(rn.astype(np.int64)), tc)[0].numpy()
    llr_diff = int((llr_t != llr_j).sum())
    assert np.abs(llr_t - llr_j).max(initial=0) <= 1
    assert llr_diff <= 1e-3 * llr_j.size
    _carry_close(res_t[4], res_j[4], llr_diff)

    # Chase combine into the reference's carry (new_data 0).
    nd = np.zeros((s, 2), np.float32)
    res2_j = [np.asarray(a) for a in ul_j(jnp.asarray(rx), jnp.asarray(res_j[4]),
                                          jnp.asarray(nd))[0]]
    res2_t = [a.numpy() for a in tsp.ul_slot_batch_mimo(
        rx, rn.astype(np.int64), tc, soft_buffer=res_j[4], new_data=nd,
        device="cpu")]
    np.testing.assert_array_equal(res2_t[0], res2_j[0])
    np.testing.assert_array_equal(res2_t[1], res2_j[1])
    _carry_close(res2_t[4], res2_j[4], 2 * llr_diff)


# ============================================================ full cell

def small_fc(n_layers) -> jfc.FullCellConfig:
    """tests/test_full_cell_mimo.py's small cell."""
    return jfc.FullCellConfig(
        nof_prb=52, nfft=1024, nof_ue=2, dl_first_prb=2, dl_prb_per_ue=20,
        ul_first_prb=2, ul_prb_per_ue=20, coreset_start_prb=2,
        coreset_nof_prb=48, ssb_first_subcarrier=192, prach_freq_prb=46,
        n_layers=n_layers)


@pytest.fixture(scope="module", params=[2, 4], ids=["2x2", "4x4"])
def cells(request):
    """Both packages' MIMO full cells on the same inputs, S = 6; the JAX
    reference computed once per layer count."""
    n_l = request.param
    jc = small_fc(n_l)
    tc = convert.full_cell_from_dict(dataclasses.asdict(jc))
    u, s = jc.nof_ue, S_FC
    rng = np.random.default_rng(n_l)
    ins = dict(
        pay_n=rng.integers(0, 2, (len(jc.norm_slots(s)), u,
                                  jc.dl_cell_mimo().derived_tbs()), dtype=np.int8),
        pay_s=rng.integers(0, 2, (len(jc.ssb_slots(s)), u,
                                  jc.dl_cell_ssb_mimo().derived_tbs()), dtype=np.int8),
        dci=rng.integers(0, 2, (s, 2 * u, jc.dci_bits), dtype=np.int8),
        pbch=rng.integers(0, 2, (len(jc.ssb_slots(s)), 24), dtype=np.int8),
        pay_u=rng.integers(0, 2, (s, u, jc.ul_cell().derived_tbs()), dtype=np.int8),
        ack=rng.integers(0, 2, (s, u, 2), dtype=np.int8),
        csi=rng.integers(0, 2, (len(jc.csi_slots(s)), u, jc.csi_bits), dtype=np.int8))
    td_j = np.asarray(jax.jit(lambda *a: jfc.gnb_dl_slot_batch_mimo(*a, jc, s))(
        ins["pay_n"], ins["pay_s"], ins["dci"], ins["pbch"]))
    ue_j = np.asarray(jax.jit(lambda *a: jfc.ue_ul_slot_batch_mimo(
        *a, jc, s, prach_amplitude=0.02))(ins["pay_u"], ins["ack"], ins["csi"]))
    rx = _awgn(np.einsum("pl,slt->spt", _mix_matrix(rng, n_l), ue_j), 25.0, rng)


    @jax.jit
    def ul(x, soft, nd):
        """The reference's receiver and its wire LLRs, one program for both
        receptions: the first one through a zero carry that new_data = 1
        clears, which is the receiver without a carry."""
        return (jfc.gnb_ul_slot_batch_mimo(x, jc, s, soft_in=soft, new_data=nd),
                jsp._ul_front_mimo(x, jc.rntis(), jc.ul_cell())[0])

    seg, rm = jsp._plans(jc.ul_cell())
    zero = jnp.zeros((s, u * seg.c, rm.n_cb), jnp.int8)
    res_j, llr_j = ul(jnp.asarray(rx), zero, jnp.ones((s, u), jnp.float32))
    res_j = {k: np.asarray(v) for k, v in res_j.items()}
    nd = np.zeros((s, u), np.float32)
    res2_j = {k: np.asarray(v) for k, v in
              ul(jnp.asarray(rx), jnp.asarray(res_j["soft"]), jnp.asarray(nd))[0].items()}
    res_t = {k: v.numpy() for k, v in
             tfc.gnb_ul_slot_batch_mimo(rx, tc, s, device="cpu").items()}
    llr = [np.asarray(llr_j),
           tsp._ul_front_mimo(_t(rx), _t(tc.rntis()), tc.ul_cell())[0].numpy()]
    return dict(jc=jc, tc=tc, ins=ins, td_j=td_j, ue_j=ue_j, rx=rx, nd=nd,
                res_j=res_j, res2_j=res2_j, res_t=res_t,
                llr_diff=int((llr[0] != llr[1]).sum()))


def test_fc_dl_samples(cells):
    ins = cells["ins"]
    td_t = tfc.gnb_dl_slot_batch_mimo(ins["pay_n"], ins["pay_s"], ins["dci"],
                                      ins["pbch"], cells["tc"], S_FC, device="cpu")
    td_j = cells["td_j"]
    assert td_t.dtype == torch.complex64 and td_t.shape == td_j.shape
    assert np.abs(td_t.numpy() - td_j).max() <= 1e-5 * np.abs(td_j).max()


def test_fc_ue_ul_samples(cells):
    ins = cells["ins"]
    ue_t = tfc.ue_ul_slot_batch_mimo(ins["pay_u"], ins["ack"], ins["csi"],
                                     cells["tc"], S_FC, prach_amplitude=0.02,
                                     device="cpu").numpy()
    assert ue_t.shape == cells["ue_j"].shape
    assert np.abs(ue_t - cells["ue_j"]).max() <= 1e-5 * np.abs(cells["ue_j"]).max()


@pytest.mark.parametrize("key", EXACT)
def test_fc_ul_exact(cells, key):
    got, want = cells["res_t"][key], cells["res_j"][key]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", CLOSE)
def test_fc_ul_close(cells, key):
    _close(cells["res_t"][key], cells["res_j"][key])


def test_fc_ul_cfo_carry_and_recovery(cells):
    """cfo to 1e-2 Hz; the carry within the wire-LLR allowance; and the
    reception is right: payload-exact, ACK / CSI exact, preamble 7 alone."""
    res, want, ins = cells["res_t"], cells["res_j"], cells["ins"]
    np.testing.assert_allclose(res["cfo"], want["cfo"], atol=1e-2)
    assert cells["llr_diff"] <= 1e-3 * res["soft"].size
    _carry_close(res["soft"], want["soft"], cells["llr_diff"])
    assert res["tb_ok"].all() and (res["payload"] == ins["pay_u"]).all()
    assert (res["ack_bits"] == ins["ack"]).all()
    assert res["csi_ok"].all() and (res["csi_bits"] == ins["csi"]).all()
    det = res["prach_detected"]
    assert det[:, 7].all() and det.sum() == det.shape[0]


@pytest.mark.parametrize("flat", [False, True])
def test_fc_harq_chase_combine(cells, flat):
    """The reference's carry through convert, chase-combined (new_data 0)
    on a second reception, in both layouts."""
    soft = cells["res_j"]["soft"]
    if flat:
        soft = soft.reshape(-1, soft.shape[-1])
    soft_t, _ = convert.harq_state_from_numpy(soft, cells["jc"].rntis(),
                                              device="cpu")
    res = tfc.gnb_ul_slot_batch_mimo(cells["rx"], cells["tc"], S_FC,
                                     soft_in=soft_t, new_data=cells["nd"],
                                     soft_flat=flat, device="cpu")
    want = cells["res2_j"]
    for key in ("payload", "tb_ok"):
        np.testing.assert_array_equal(res[key].numpy(), want[key])
    assert res["soft"].shape == soft.shape
    _carry_close(res["soft"].numpy(), want["soft"].reshape(soft.shape),
                 2 * cells["llr_diff"])


def test_default_4x4_full_cell_refused_by_both():
    """FullCellConfig(n_layers=4) at 24 PRB per UE segments into non-uniform
    E: the reference asserts, the port raises ValueError."""
    jc = jfc.FullCellConfig(n_layers=4)
    tc = convert.full_cell_from_dict(dataclasses.asdict(jc))
    with pytest.raises(AssertionError):
        jsp._plans(jc.ul_cell(), 0)
    with pytest.raises(ValueError, match="uniform-E"):
        tsp._plans(tc.ul_cell(), 0)


def test_config_conversion_carries_layers_and_delay_spread():
    jc = dataclasses.replace(small_fc(2), ul_delay_spread_us=1.0)
    tc = convert.full_cell_from_dict(dataclasses.asdict(jc))
    # The port's config has the JAX package's fields and the TDD slot
    # pattern's, which default to paired spectrum.
    want = dataclasses.asdict(jc)
    got = dataclasses.asdict(tc)
    assert {k: got[k] for k in want} == want
    assert {k: v for k, v in got.items() if k not in want} == {
        "tdd_period": 0, "tdd_dl_slots": 0, "tdd_dl_symbols": 0,
        "tdd_ul_slots": 0, "tdd_ul_symbols": 0}
    for jcell, tcell in ((jc.ul_cell(), tc.ul_cell()),
                         (jc.dl_cell_mimo(), tc.dl_cell_mimo()),
                         (jc.dl_cell_ssb_mimo(), tc.dl_cell_ssb_mimo())):
        assert dataclasses.asdict(tcell) == dataclasses.asdict(jcell)
        assert convert.cell_from_dict(dataclasses.asdict(jcell)) == tcell
    assert tc.ul_cell().n_layers == 2 and tc.ul_cell().delay_spread_us == 1.0
    assert tc.dl_cell_mimo().derived_tbs() == jc.dl_cell_mimo().derived_tbs()


def test_4x4_wire_decoder_floor_is_the_references():
    """bench.py's 4x4 data-plane point (106 PRB, 4 UEs x 26 PRB, 64QAM r0.5,
    bench.py's own 4x4 channel, 25 dB), S = 2, seed 3: one TB of 8 fails CRC
    in both packages alike, because one codeblock never meets parity in the
    wire decode (layered_wire, which the port's K1 reproduces); the JAX
    package's f32 layered decoder recovers it from the same decoder input
    (ROADMAP.md Queue C)."""
    jc = jsp.CellConfig(nof_prb=106, nfft=1536, nof_ue=4, prb_per_ue=26,
                        modulation="qam64", target_rate=0.5, n_layers=4)
    tc = convert.cell_from_dict(dataclasses.asdict(jc))
    rn = (0x4601 + np.arange(4)).astype(np.uint32)
    rng0 = np.random.default_rng(0)            # bench_mimo's channel draw
    rng0.integers(0, 2, (256, 4, jc.derived_tbs()), dtype=np.int8)
    a = (rng0.normal(size=(4, 4)) + 1j * rng0.normal(size=(4, 4))) / np.sqrt(2)
    f = np.exp(-2j * np.pi * np.outer(np.arange(4), np.arange(4)) / 4)
    mix = (0.35 * a + f / 2).astype(np.complex64)
    rng = np.random.default_rng(3)
    pay = rng.integers(0, 2, (2, 4, jc.derived_tbs()), dtype=np.int8)
    td = tsp.dl_slot_batch_mimo(pay, rn.astype(np.int64), tc, device="cpu").numpy()
    nv = float(np.mean(np.abs(td) ** 2)) * 10 ** (-25 / 10)
    rx = np.einsum("pl,slt->spt", mix, td)
    rx = (rx + (rng.normal(size=rx.shape) + 1j * rng.normal(size=rx.shape))
          * np.sqrt(nv / 2)).astype(np.complex64)

    res_t = [x.numpy() for x in tsp.ul_slot_batch_mimo(rx, rn.astype(np.int64), tc,
                                                       device="cpu")]
    seg, rm = jsp._plans(jc)

    @jax.jit
    def reference(x):
        """The reference's front, dematch, wire and f32 decodes: one program."""
        llr = jsp._ul_front_mimo(x, jnp.asarray(rn), jc)[0]
        full = jrm.rate_dematch(llr.reshape(-1, rm.e), rm, None, dtype=jnp.bfloat16,
                                saturate=True)
        _, ok_wire = jdec.decode(full.astype(jnp.float32), seg.bg, seg.zc,
                                 schedule="layered_wire")
        hard, ok_f32 = jdec.decode(full.astype(jnp.float32) / 6.0, seg.bg, seg.zc,
                                   schedule="layered")
        return (ok_wire, ok_f32) + tuple(jseg.desegment_tb(hard, seg))

    ok_wire, ok_f32, pay_f32, tb_f32 = reference(jnp.asarray(rx))
    ok_wire = np.asarray(ok_wire).reshape(8, seg.c).all(axis=1).reshape(2, 4)
    assert (~res_t[1]).sum() == 1 and not res_t[1][1, 3]
    np.testing.assert_array_equal(res_t[1], ok_wire)
    np.testing.assert_array_equal(res_t[0][res_t[1]], pay[res_t[1]])
    assert np.asarray(ok_f32).all() and np.asarray(tb_f32).all()
    np.testing.assert_array_equal(np.asarray(pay_f32).reshape(pay.shape), pay)
