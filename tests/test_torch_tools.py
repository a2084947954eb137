"""Parity of the port's validation entry points
(``srsran_edgeric_5g_tpu_torch/tools/``) with the JAX package's tools on the
same numpy-seeded inputs, on the CPU (the kernels' plain versions).

  * Bit-level outputs are equal: per-TB outcomes, hard bits, payloads, the
    decodes of every schedule, the scheduler's layouts.
  * Demapped wire LLRs are integers from float32 fronts whose operations
    the two packages order differently: a ±1 step is allowed in at most
    1e-3 of the entries.
  * The RLF run decodes exactly its duty cycle, 12 of 20 slots.

The JAX references are jitted once per test (one program per reference
run); shapes are cut to a few PRB and a few TBs.
"""

import contextlib
import importlib.util
import io
import os
import pathlib
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.models import pusch as jpu
from srsran_edgeric_5g_tpu.ops import modulation as jmod
from srsran_edgeric_5g_tpu.ops import ofdm as jofdm
from srsran_edgeric_5g_tpu.ops.ldpc import decoder as jdec
from srsran_edgeric_5g_tpu.ops.ldpc import encoder as jenc
from srsran_edgeric_5g_tpu.ops.ldpc import rate_match as jrm
from srsran_edgeric_5g_tpu.ops.ldpc import segmenter as jseg
from srsran_edgeric_5g_tpu.ran import numerology as jnum
from srsran_edgeric_5g_tpu_torch.ops import channel_model as tchm
from srsran_edgeric_5g_tpu_torch.tools import bler_channel_sweep as tcs
from srsran_edgeric_5g_tpu_torch.tools import bler_parity as tbp
from srsran_edgeric_5g_tpu_torch.tools import bler_sweep as tbs
from srsran_edgeric_5g_tpu_torch.tools import chest_bler_ab as tab
from srsran_edgeric_5g_tpu_torch.tools import kernel_bench as tkb
from srsran_edgeric_5g_tpu_torch.tools import sched_churn as tsc

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOOLS = ("bler_sweep", "bler_parity", "bler_channel_sweep", "chest_bler_ab",
         "sched_churn", "kernel_bench")


def _jax_tool(name: str):
    """The JAX package's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wire_close(got, want):
    """Integer-valued LLRs: equal but for ±1 steps in at most 1e-3."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def _jax_sweep_point(mcs_idx, snr_db, n_blocks, rng, nof_prb):
    """``tools/bler_sweep.py:17``'s chain through the JAX package, jitted,
    drawing from ``rng`` in its order -> (decoder input, hard, tb_ok)."""
    from srsran_edgeric_5g_tpu.ran import tbs as jtbs
    mcs = jtbs.mcs_config(mcs_idx, "qam64")
    nre = jtbs.nof_re(nof_prb, 12, 12)
    a = jtbs.tbs(nre, mcs.target_rate, mcs.qm)
    bg = jseg.select_base_graph(a, mcs.target_rate)
    seg = jseg.get_segment_plan(a, bg, nre * mcs.qm, mcs.qm)
    rm = jrm.get_rate_match_plan(seg.bg, seg.zc, seg.e[0], 0, mcs.qm, seg.k_prime)
    payload = rng.integers(0, 2, (n_blocks, a), dtype=np.int8)
    syms = np.asarray(jax.jit(lambda p: jmod.modulate(jrm.rate_match(
        jenc.encode(jseg.segment_tb(p, seg), seg.bg, seg.zc), rm), mcs.modulation))(
        jnp.asarray(payload)))
    nv = 10 ** (-snr_db / 10)
    noise = rng.normal(size=syms.shape) + 1j * rng.normal(size=syms.shape)
    y = (syms + noise * np.sqrt(nv / 2)).astype(np.complex64)

    @jax.jit
    def rx(y):
        llr = jmod.demodulate_soft(y, jnp.float32(nv), mcs.modulation
                                   ).astype(jnp.float32)
        full = jrm.rate_dematch(llr.reshape(-1, rm.e), rm)
        hard, _ = jdec.decode(full, seg.bg, seg.zc, num_iters=8)
        return full, hard, jseg.desegment_tb(hard, seg)[1]
    return tuple(np.asarray(v) for v in rx(jnp.asarray(y)))


@pytest.mark.parametrize("mcs_idx,snr_db", [(4, -1.0), (24, 15.5)])
def test_bler_sweep_point_equals_the_reference_chain(mcs_idx, snr_db):
    """One waterfall point (8 PRB, 8 TBs, both passing and failing TBs):
    per-TB outcomes and hard bits equal to the JAX chain's on the same numpy
    draws; LLRs within the ±1-step allowance."""
    p = tbs.run_point(mcs_idx, snr_db, 8, np.random.default_rng(11), nof_prb=8,
                      device="cpu")
    full, hard, tb_ok = _jax_sweep_point(mcs_idx, snr_db, 8,
                                         np.random.default_rng(11), 8)
    assert 0 < tb_ok.sum() < 8                      # a waterfall point
    _wire_close(p.llrs.numpy(), full)
    np.testing.assert_array_equal(p.hard.numpy(), hard)
    np.testing.assert_array_equal(p.tb_ok.numpy(), tb_ok)


def test_bler_parity_schedules_equal_the_reference_schedules():
    """The int8 buffer equals the JAX tool's (±1 step); on the port's buffer
    wire_auto, layered_rolls_i8 and auto decode (plain, chunked with a batch
    exit per chunk) equal the JAX package's layered_wire, layered_rolls_i8
    and layered on the same chunks, bit for bit."""
    jtool = _jax_tool("bler_parity")
    mcs_idx, n_blocks, snr, chunk = 4, 24, -1.0, 8
    rng = np.random.default_rng(1004)
    _, _, seg, rm, tx_cbs, syms = tbp.build_point(mcs_idx, n_blocks, rng,
                                                  nof_prb=8, device="cpu")
    buf = tbp.llr_buffer(rm, syms, snr, rng, device="cpu")
    jrng = np.random.default_rng(1004)
    with jax.default_device(jax.devices("cpu")[0]):
        _, _, jseg_, jrm_, jtx, jsyms = jtool.build_point(mcs_idx, n_blocks, jrng,
                                                         nof_prb=8)
        jbuf = jtool.llr_buffer(jseg_, jrm_, jsyms, snr, jrng)
    np.testing.assert_array_equal(tx_cbs, jtx)
    _wire_close(buf.numpy(), jbuf)
    refs = {"wire_auto": ("layered_wire", np.float32),
            "layered_rolls_i8": ("layered_rolls_i8", np.int8),
            "auto": ("layered", np.float32)}
    x = buf.numpy().reshape(n_blocks // chunk, chunk, -1)
    outcomes = set()
    for ours, (theirs, dtype) in refs.items():
        got = tbp.decode_ours(buf, seg, tbp.NUM_ITERS, ours, chunk=chunk).numpy()
        want = jax.jit(lambda v, s=theirs: jax.lax.map(
            lambda c: jdec.decode(c, seg.bg, seg.zc, num_iters=tbp.NUM_ITERS,
                                  schedule=s)[0], v))(jnp.asarray(x.astype(dtype)))
        np.testing.assert_array_equal(got, np.asarray(want).reshape(got.shape))
        outcomes.add(tbp.tb_bler(torch.as_tensor(got), tx_cbs, seg.c))
    assert any(0 < b < 1 for b in outcomes)          # a waterfall point


def test_bler_channel_sweep_slot_equals_pusch_process():
    """TDL-A-faded noisy slots made with numpy, through the port's front and
    per-TB decode and through the JAX package's pusch.process (TA +
    smoothing estimator at the profile's delay spread): tb_ok and payload
    exact."""
    su = tcs.setup("cpu")
    rng = np.random.default_rng(23)
    payloads = rng.integers(0, 2, (4, su.tbs), dtype=np.int8)
    td = tcs.transmit(payloads, su).numpy()
    ch = tchm.make_tdl("tdla", su.timing.srate)
    h = ((rng.normal(size=(4, len(ch.taps))) + 1j * rng.normal(size=(4, len(ch.taps))))
         * np.sqrt(ch.powers / 2))
    faded = np.zeros_like(td)
    for i, d in enumerate(ch.taps):
        faded[:, d:] += h[:, i, None] * td[:, :td.shape[1] - d]
    nv = np.mean(np.abs(faded) ** 2) * 10 ** (-8.0 / 10)
    rx = (faded + np.sqrt(nv / 2) * (rng.normal(size=td.shape)
                                    + 1j * rng.normal(size=td.shape))).astype(np.complex64)
    ds = tcs.delay_spread("tdla", su)
    payload, ok, _ = tcs.rx(torch.as_tensor(rx), su, ds)

    t = jnum.slot_timing(**jnum.CELL_10MHZ)
    cfg = jpu.PdschConfig(rnti=0x11, nof_prb=24, start_prb=4, modulation="qam16",
                          target_rate=0.4)

    @jax.jit
    def ref(x):
        def one(s):
            r = jpu.process(jofdm.demodulate_slot(s, t, scale=1.0), cfg, t.srate,
                            su.times, delay_spread_s=ds)
            return r.payload[0], r.tb_crc_ok[0]
        return jax.vmap(one)(x)
    jpay, jok = ref(jnp.asarray(rx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(payload.numpy(), np.asarray(jpay))
    assert 0 < int(ok.sum())


def test_rlf_run_decodes_the_duty_cycle():
    """3 ms on / 2 ms off at 25 dB over 20 slots: exactly 12 decode."""
    su = tcs.setup("cpu")
    payloads = np.random.default_rng(5).integers(0, 2, (tcs.RLF_SLOTS, su.tbs),
                                                 dtype=np.int8)
    ok, _ = tcs.rlf_run(payloads, torch.Generator().manual_seed(3), su)
    assert int(ok.sum()) == 12 and ok.numpy().mean() == tcs.RLF_DUTY
    np.testing.assert_array_equal(ok.numpy().reshape(4, 5),
                                  np.tile([True] * 3 + [False] * 2, (4, 1)))


def test_chest_bler_ab_grids_and_outcomes_equal_the_reference():
    """4 grids at MCS 15, 10.5 dB, both estimators: the noisy grids are the
    JAX tool's, and tb_ok equals a vmap of the JAX package's pusch.process
    on them."""
    jtool = _jax_tool("chest_bler_ab")
    case = tab.Case(15, 4, "cpu")
    grids = case.grids(10.5)
    jcfg, _, a = jtool.make_cfg(15)
    assert a == case.tbs
    rng = np.random.default_rng(77 + 15)
    payloads = rng.integers(0, 2, (4, a), dtype=np.int8)
    hgrid = jtool.channel_response(624, 14, case.times)
    clean = np.asarray(jax.jit(jax.vmap(
        lambda p: jpu.transmit(p[None], jcfg, 14, 624)))(jnp.asarray(payloads))) * hgrid
    sig = float(np.mean(np.abs(clean[clean != 0]) ** 2))
    sigma = np.sqrt(sig * 10 ** (-10.5 / 10) / 2)
    noise = (rng.normal(size=clean.shape) + 1j * rng.normal(size=clean.shape)) * sigma
    jgrids = (clean + noise).astype(np.complex64)
    np.testing.assert_allclose(grids.numpy(), jgrids, atol=2e-6 * np.abs(jgrids).max())
    outcomes = []
    for ds in (None, tab.TA_DELAY_SPREAD_S):
        ok, _ = case.rx(grids, ds)
        want = jax.jit(jax.vmap(lambda g, ds=ds: jpu.process(
            g, jcfg, case.timing.srate, case.times,
            delay_spread_s=ds).tb_crc_ok[0]))(jnp.asarray(grids.numpy()))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(want))
        outcomes += ok.tolist()
    assert any(outcomes) and not all(outcomes)


def test_sched_churn_layouts_equal_the_reference_tool():
    """run_scheduler(200): the same layout Counter and first slots as
    tools/sched_churn.py's."""
    _, layouts, first_seen = tsc.run_scheduler(200)
    _, jlayouts, jfirst = _jax_tool("sched_churn").run_scheduler(200)
    assert isinstance(layouts, Counter) and layouts == jlayouts
    assert first_seen == jfirst
    assert len(layouts) > 5
    assert tsc.discovered(first_seen, 200) == {
        m: sum(1 for v in jfirst.values() if v < m) for m in (10, 50, 100)}


def test_kernel_bench_prints_a_line_per_stage():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tkb.main(["--device", "cpu", "--iters", "1"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == "device: cpu"
    stages = [ln.split()[0] for ln in lines[1:]]
    assert stages == ["fft_1536_batch224", "ldpc_enc_bg1_zc384_b64",
                      "ldpc_dec_auto_es_b64", "ldpc_dec_k1_fixed6_b64", "qam64_map",
                      "qam64_softdemap", "mmse_1x1_eq", "chest_64ue",
                      "prach_detect_64pre"]
    assert all(ln.split()[2] == "ms" and float(ln.split()[1]) > 0 for ln in lines[1:])


def test_tools_import_no_jax():
    """Each tool module imports neither JAX nor the JAX package nor tools/."""
    code = ("import sys\n"
            + "".join(f"import srsran_edgeric_5g_tpu_torch.tools.{n}\n" for n in TOOLS)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'srsran_edgeric_5g_tpu', 'tools')]\n"
              "print(bad)\nassert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd="/",
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_device_is_required_unless_cpu_is_asked(monkeypatch):
    """--device cuda (the default) raises on a host without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        tsc.main(["--slots", "10", "--compile"])
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        tbs.main([])


def jax_chest_columns(n_blocks: int, chunk: int = 50):
    """The JAX package's two receiver columns of tools/chest_bler_ab.py at
    ``n_blocks`` TBs per point (its grids, its draws; the reference
    receiver's column needs native/refharness): -> {mcs: [(snr, failed TBs
    default, failed TBs TA)]}.  Run as
    ``JAX_PLATFORMS=cpu python tests/test_torch_tools.py chest 300``; the
    port's counterpart is ``python -m srsran_edgeric_5g_tpu_torch.tools.
    chest_bler_ab --blocks 300``."""
    jtool = _jax_tool("chest_bler_ab")
    t = jnum.slot_timing(**jnum.CELL_10MHZ)
    times = np.asarray(t.cp.data_starts)[:14] / t.srate
    out = {}
    for mcs_idx, _, grid in jtool.CASES:
        cfg, _, a = jtool.make_cfg(mcs_idx)
        rng = np.random.default_rng(77 + mcs_idx)
        payloads = rng.integers(0, 2, (n_blocks, a), dtype=np.int8)
        clean = np.asarray(jax.jit(jax.vmap(
            lambda p: jpu.transmit(p[None], cfg, 14, 624)))(jnp.asarray(payloads))) \
            * jtool.channel_response(624, 14, times)
        sig = float(np.mean(np.abs(clean[clean != 0]) ** 2))
        rx = {ds: jax.jit(jax.vmap(lambda g, ds=ds: jpu.process(
            g, cfg, t.srate, times, delay_spread_s=ds).tb_crc_ok[0]))
            for ds in (None, 1.5 * (jtool.TAU0_S + jtool.ECHO_S))}
        rows = []
        for snr in grid:
            sigma = np.sqrt(sig * 10 ** (-snr / 10) / 2)
            noise = (rng.normal(size=clean.shape)
                     + 1j * rng.normal(size=clean.shape)) * sigma
            grids = (clean + noise).astype(np.complex64)
            fails = [sum(int((~np.asarray(f(jnp.asarray(grids[i:i + chunk])))).sum())
                         for i in range(0, n_blocks, chunk)) for f in rx.values()]
            rows.append((float(snr), *fails))
            print(f"MCS {mcs_idx} {snr:+.2f} dB: failed TBs default {fails[0]} "
                  f"ta {fails[1]} of {n_blocks}", flush=True)
        out[mcs_idx] = rows
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["chest"]:
        jax_chest_columns(int(sys.argv[2]))
