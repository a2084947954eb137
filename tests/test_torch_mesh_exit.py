"""K1's early stop over the ranks of a mesh, on the CPU (the plain rule).

The JAX package decodes a sharded batch with one ``lax.while_loop`` whose
predicate is ``jnp.all(parity_fn(s))`` over the global batch, a reduction
over every device; the port's ``decode(process_groups=...)`` all-reduces
the same predicate over the ranks, and ``slot_pipeline._ul_back`` passes
its mesh's codeblock groups.  Two ranks run ``parallel.multihost``'s
``exit`` program (--device cpu --backend gloo, one torch thread each, a
file:// store under tmp_path) on the inputs of ``multihost.exit_inputs``,
written to an .npz:

  * decode level: the waterfall pair of tools/bler_sweep.py's MCS 24, 16 dB
    point, one codeblock per rank, through decode("auto") (codeblocks 121
    and 124: 124 meets parity after 7 sweeps, misses it after 8) and
    decode("wire_auto") (121 and 122), equal to mesh=None and to the JAX
    package's "layered" / "layered_wire" over the whole batch, where an
    exit per rank's share gives another ``ok``;
  * path level: ``_ul_back`` on a 2-rank 'cb' mesh on two TBs of
    multihost.EXIT_CELL at 16.5 dB, one per rank: payloads, TB CRC flags
    and the bits and ``ok`` of the decode it makes equal mesh=None's, where
    an exit per rank's share gives another ``ok``;
  * a rank with no codeblocks beside one with the waterfall pair: it takes
    part in every collective and launches nothing.

Every comparison is exact (bits, ``ok``, TB CRC flags).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder as tdec
from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder_cuda as tdc
from srsran_edgeric_5g_tpu_torch.parallel import multihost as mh
from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as tsp

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
WAIT_S = 120
SCHEDULES = {"auto": ("auto", "layered"), "wire": ("wire_auto", "layered_wire")}


def _jax_decodes(inputs: dict) -> dict:
    """The JAX package's decode of each whole decode case, one jitted
    program: {case: (hard, ok)}."""
    import jax
    import jax.numpy as jnp
    from srsran_edgeric_5g_tpu.ops.ldpc import decoder as jdec
    cases = sorted(SCHEDULES)

    @jax.jit
    def run(*xs):
        out = []
        for name, x in zip(cases, xs):
            bg, zc, n = (int(v) for v in inputs[f"{name}/meta"])
            out.append(jdec.decode(x, bg, zc, num_iters=n, schedule=SCHEDULES[name][1]))
        return out

    got = run(*(jnp.asarray(inputs[f"{c}/llrs"].astype(np.float32)) for c in cases))
    return {c: tuple(np.asarray(a) for a in r) for c, r in zip(cases, got)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' outputs, the inputs, and the JAX decodes (computed
    while the ranks run)."""
    tmp = tmp_path_factory.mktemp("exit")
    inputs = mh.exit_inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "srsran_edgeric_5g_tpu_torch.parallel.multihost",
         str(r), str(WORLD), f"file://{tmp / 'store'}", "--device", "cpu",
         "--backend", "gloo", "--programs", "exit", "--inputs",
         str(tmp / "inputs.npz"), "--out", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(WORLD)]
    outs = []
    try:
        jax_out = _jax_decodes(inputs)
        for p in procs:
            outs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {WORLD} failed:\n{out[-6000:]}"
    got = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return dict(got=got, inputs=inputs, jax=jax_out)


def _case(ranks, name):
    inputs = ranks["inputs"]
    bg, zc, n = (int(v) for v in inputs[f"{name}/meta"])
    x = torch.as_tensor(inputs[f"{name}/llrs"])
    return x, bg, zc, n, inputs[f"{name}/bounds"]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_decode_exit_spans_the_ranks(ranks, name):
    """One waterfall codeblock per rank: the ranks' bits and ok together
    equal decode() of the whole batch (mesh=None) and the JAX package's
    decode of it; an exit per rank's share (exit_group 1) gives another
    ok, so a rank that stopped on its own share would fail here."""
    x, bg, zc, n, bounds = _case(ranks, name)
    assert list(bounds) == [0, 1, 2]
    hard, ok = tdec.decode(x, bg, zc, n, schedule=SCHEDULES[name][0])
    got_hard = np.concatenate([g[f"exit/{name}/hard"] for g in ranks["got"]])
    got_ok = np.concatenate([g[f"exit/{name}/ok"] for g in ranks["got"]])
    np.testing.assert_array_equal(got_hard, hard.numpy())
    np.testing.assert_array_equal(got_ok, ok.numpy())
    jh, jo = ranks["jax"][name]
    np.testing.assert_array_equal(got_hard, jh)
    np.testing.assert_array_equal(got_ok, jo)
    share = tdc.decode_layered_plain(x, bg, zc, n, wire=x.dtype == torch.int8,
                                     early_stop=True, strict=False, exit_group=1)
    assert not torch.equal(share[1], ok), "the shares' exits give the whole batch's ok"
    assert share[2].tolist() != [n, n] and not ok.all()


def test_ul_back_exit_spans_the_ranks(ranks):
    """_ul_back on a 2-rank 'cb' mesh, one TB per rank: every rank's
    gathered payloads and TB CRC flags, and the bits and ok of the decode
    each rank made of its codeblocks, equal mesh=None's, whose batch runs
    all 7 sweeps; decoding each rank's share on its own (exit_group = the
    share) stops rank 0's TB after 6 with another ok."""
    inputs = ranks["inputs"]
    cell = tsp.CellConfig(**json.loads(str(inputs["path/cell"])))
    n = int(inputs["path/num_iters"])
    llr = torch.as_tensor(inputs["path/llr"])
    pay, tb_ok, _ = tsp._ul_back(llr, cell, num_iters=n)
    seg, _ = tsp._plans(cell)
    full = tsp._decoder_input(llr, cell)
    hard, ok = tdec.decode(full, seg.bg, seg.zc, n, schedule="wire_auto")
    for g in ranks["got"]:
        np.testing.assert_array_equal(g["exit/path/payload"], pay.numpy())
        np.testing.assert_array_equal(g["exit/path/tb_ok"], tb_ok.numpy())
    np.testing.assert_array_equal(
        np.concatenate([g["exit/path/hard"] for g in ranks["got"]]), hard.numpy())
    np.testing.assert_array_equal(
        np.concatenate([g["exit/path/ok"] for g in ranks["got"]]), ok.numpy())
    share = tdc.decode_layered_plain(full, seg.bg, seg.zc, n, wire=True,
                                     early_stop=True, exit_group=full.shape[0] // WORLD)
    whole = tdc.decode_layered_plain(full, seg.bg, seg.zc, n, wire=True, early_stop=True)
    assert share[2].tolist() == [6, 6, n, n] and whole[2].tolist() == [n] * 4
    assert not torch.equal(share[1], whole[1]), "the shares' exits give the whole batch's ok"


def test_rank_without_codeblocks(ranks):
    """Rank 0 holds the waterfall pair, rank 1 none: rank 0's result is the
    whole batch's, rank 1 returns empty results, launches nothing and does
    not hang the collectives."""
    x, bg, zc, n, bounds = _case(ranks, "empty")
    assert list(bounds) == [0, 2, 2]
    hard, ok = tdec.decode(x, bg, zc, n)
    r0, r1 = ranks["got"]
    np.testing.assert_array_equal(r0["exit/empty/hard"], hard.numpy())
    np.testing.assert_array_equal(r0["exit/empty/ok"], ok.numpy())
    assert r1["exit/empty/hard"].shape == (0, hard.shape[1])
    assert r1["exit/empty/ok"].shape == (0,)
    assert int(r1["exit/empty/launches"]) == 0
