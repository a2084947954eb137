"""The port's scale-out on the CPU: parallel/mesh.py, the mesh= path of
the slot and full-cell programs, and parallel/multihost.py over gloo.

Ranks run as subprocesses of ``parallel.multihost`` (--device cpu
--backend gloo, one torch thread each, a file:// store under tmp_path,
LOCAL_WORLD_SIZE=2), started once per world in the module fixture:

  * 4 ranks as 2 hosts run the worker's two programs, the single-cell step
    on (ue 2, cb 2) and the carrier step on (host 2, ue 1, cb 2), held
    against the JAX package's same steps on its 8 CPU devices
    (make_mesh_hostmajor(4, 2), make_cell_mesh(2, 2, 2)), one jitted
    program; and the SISO full gNB slot and the 4x4 data plane, held
    against the port's mesh=None in this process;
  * 3 ranks on the 'ue' axis: 4 UEs split 2, 2, 0, so one rank holds no row
    and no codeblock; the step and the 4x4 data plane against mesh=None.

Tolerances: payloads, tb_ok, the int8 HARQ carry, ACK / CSI bits and PRACH
detections exact on every rank; samples within 1e-4 (the port's FFT-order
bound, tests/test_torch_timeblock.py); noise_var and cfo within 1e-4 of
the peak; the other floats of the full cell as tests/test_torch_full_cell
.py holds them (1e-4 of the peak).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from srsran_edgeric_5g_tpu.parallel import mesh as jmesh
from srsran_edgeric_5g_tpu.parallel import slot_pipeline as jsp
from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder as tdec
from srsran_edgeric_5g_tpu_torch.ops.ldpc import decoder_cuda as tdc
from srsran_edgeric_5g_tpu_torch import cuda_build
from srsran_edgeric_5g_tpu_torch.parallel import mesh as tmesh
from srsran_edgeric_5g_tpu_torch.parallel import multihost as mh
from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as tsp

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
WAIT_S = 120
WORLDS = {4: ("cell", "carrier", "full_cell", "mimo4", "layout"),
          3: ("uneven", "mimo4", "layout")}
SAMPLE_ATOL, RTOL = 1e-4, 1e-4
CPU = torch.device("cpu")


def _start(world: int, tmp: pathlib.Path) -> list:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               LOCAL_WORLD_SIZE="2")
    env.pop("LOCAL_RANK", None)
    return [subprocess.Popen(
        [sys.executable, "-m", "srsran_edgeric_5g_tpu_torch.parallel.multihost",
         str(r), str(world), f"file://{tmp / 'store'}", "--device", "cpu",
         "--backend", "gloo", "--programs", ",".join(WORLDS[world]),
         "--out", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]


def _finish(procs: list, tmp: pathlib.Path) -> dict:
    """Every rank's exit, its output in the failure message; then the
    ranks' saved outputs and rank 0's report line."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {len(procs)} failed:\n{out[-6000:]}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(len(procs))]
    line = next(ln for ln in outs[0].splitlines() if ln.startswith("MULTIHOST_OK"))
    return {"ranks": ranks, "line": line,
            "summary": json.loads(str(ranks[0]["summary"]))}


def _reference_steps():
    """The JAX package's worker steps on its 8 CPU devices, with the
    worker's seeded inputs and noise, as one jitted program."""
    cell, ccell = mh.worker_cell(), mh.carrier_cell()
    rng = np.random.default_rng(mh.SEED + mh.PROGRAMS.index("cell"))
    pay = rng.integers(0, 2, (cell.nof_ue, cell.derived_tbs()), dtype=np.int8)
    total = cell.timing.cp.total
    z = (rng.normal(size=total), rng.normal(size=total))
    crng = np.random.default_rng(mh.SEED + mh.PROGRAMS.index("carrier"))
    cpay = crng.integers(0, 2, (2, 2, ccell.nof_ue, ccell.derived_tbs()),
                         dtype=np.int8)
    cshape = (2, 2, ccell.timing.cp.total)
    cz = (crng.normal(size=cshape), crng.normal(size=cshape))
    jc = jsp.CellConfig(**{k: getattr(cell, k) for k in
                           ("nof_prb", "nfft", "nof_ue", "prb_per_ue",
                            "modulation", "target_rate")})
    jcc = jsp.CellConfig(**{k: getattr(ccell, k) for k in
                            ("nof_prb", "nfft", "nof_ue", "prb_per_ue",
                             "modulation", "target_rate")})
    mesh = jmesh.make_mesh_hostmajor(4, 2)
    cmesh = jmesh.make_cell_mesh(2, 2, 2)
    rntis = jnp.arange(1, cell.nof_ue + 1, dtype=jnp.uint32)
    crntis = jnp.asarray((1 + np.arange(4)).reshape(2, 2), dtype=jnp.uint32)
    snr = 10 ** (-mh.SNR_DB / 10)

    def noisy(td, zr, zi, axes):
        var = jnp.mean(jnp.abs(td) ** 2, axis=axes, keepdims=True) * snr
        return td + ((zr + 1j * zi) * jnp.sqrt(var / 2)).astype(jnp.complex64)

    @jax.jit
    def steps(p, zr, zi, cp, czr, czi):
        td = jsp.dl_slot(p, rntis, jc, mesh=mesh)
        ul = jsp.ul_slot(noisy(td, zr, zi, None), rntis, jc, mesh=mesh)
        ctd = jsp.multi_cell_dl_slot_batch(cp, crntis, jcc, mesh=cmesh)
        cul = jsp.multi_cell_ul_slot_batch(noisy(ctd, czr, czi, (1, 2)), crntis,
                                           jcc, mesh=cmesh)
        return td, ul, ctd, cul

    cp = jax.device_put(cpay, NamedSharding(cmesh, P(jmesh.CELL_AXIS)))
    td, ul, ctd, cul = steps(jnp.asarray(pay), *z, cp, *cz)
    keys = ("payload", "tb_ok", "noise_var", "cfo", "soft")
    return ({"samples": np.asarray(td), **dict(zip(keys, map(np.asarray, ul)))},
            {"samples": np.asarray(ctd), **dict(zip(keys, map(np.asarray, cul)))})


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds started at once; the references computed meanwhile."""
    tmps = {w: tmp_path_factory.mktemp(f"world{w}") for w in WORLDS}
    procs = {w: _start(w, tmps[w]) for w in WORLDS}
    try:
        cell_ref, carrier_ref = _reference_steps()
        none = {
            "uneven": mh.cell_step(None, mh.worker_cell(), CPU, np.random.default_rng(
                mh.SEED + mh.PROGRAMS.index("uneven")))[0],
            "mimo4": mh.mimo_step(None, mh.mimo4_cell(), CPU, np.random.default_rng(
                mh.SEED + mh.PROGRAMS.index("mimo4")))[0],
            "full_cell": mh.full_cell_step(
                None, mh.small_full_cell(), 6, CPU,
                np.random.default_rng(mh.SEED + mh.PROGRAMS.index("full_cell")))[0],
        }
    finally:
        done = {w: _finish(procs[w], tmps[w]) for w in WORLDS}
    return dict(done=done, cell_ref=cell_ref, carrier_ref=carrier_ref, none=none)


def _outputs(rank: dict, program: str) -> dict:
    pre = f"{program}/"
    return {k[len(pre):]: v for k, v in rank.items() if k.startswith(pre)}


def _hold(got: dict, want: dict, exact, close=()) -> None:
    for k in exact:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in close:
        err = np.abs(got[k] - want[k]).max(initial=0.0)
        assert err <= RTOL * np.abs(want[k]).max(initial=0.0), (k, err)
    for k in got:
        if k.endswith("samples"):
            assert got[k].shape == want[k].shape
            assert np.abs(got[k] - want[k]).max() <= SAMPLE_ATOL, k


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("program", ["cell", "carrier"])
def test_worker_steps_equal_the_reference(worlds, program, rank):
    """Each rank's gathered results of the worker's two programs: the JAX
    package's sharded step's, and the sent payloads."""
    got = _outputs(worlds["done"][4]["ranks"][rank], program)
    want = worlds[f"{program}_ref"]
    _hold(got, want, mh.STEP_EXACT, mh.STEP_CLOSE)
    np.testing.assert_array_equal(got["payload"], got["sent"])


def test_worker_report_and_tally(worlds):
    """MULTIHOST_OK for 2 hosts of 2 ranks; the single-cell step gathered
    over 'ue' and over 'cb', the carrier step never over 'host'."""
    done = worlds["done"][4]
    assert done["line"].startswith("MULTIHOST_OK procs=2 ranks=4 device=cpu")
    tally = {p: done["summary"][p]["collectives"] for p in WORLDS[4]}
    assert tally["cell"]["ue"]["count"] >= 1 and tally["cell"]["cb"]["count"] >= 1
    assert "host" not in tally["carrier"] and tally["carrier"]["cb"]["count"] >= 1
    assert all(v["bytes"] > 0 for t in tally.values() for v in t.values())


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_blocks_are_dtensors(worlds, world):
    """Every rank found DTensor's own split of 0-12 rows over 'ue' and over
    ('ue', 'cb') equal to row_block's, and full_tensor() equal to unshard."""
    for rank in worlds["done"][world]["ranks"]:
        assert int(rank["layout/checked"]) == 26


def test_mesh_builders(worlds):
    """Shapes, axis names and host-major grouping of the meshes the worker
    built (LOCAL_WORLD_SIZE=2: ranks 0-1 on host 0, 2-3 on host 1)."""
    s4, s3 = worlds["done"][4]["summary"], worlds["done"][3]["summary"]
    assert s4["cell"]["mesh"] == {"names": ["ue", "cb"], "ranks": [[0, 1], [2, 3]]}
    assert s4["carrier"]["mesh"] == {"names": ["host", "ue", "cb"],
                                     "ranks": [[[0, 1]], [[2, 3]]]}
    assert s4["mimo4"]["mesh"] == {"names": ["ue", "cb"], "ranks": [[0, 1], [2, 3]]}
    assert s3["uneven"]["mesh"] == {"names": ["ue", "cb"], "ranks": [[0], [1], [2]]}


@pytest.mark.parametrize("world,program", [(3, "uneven"), (3, "mimo4"),
                                           (4, "mimo4"), (4, "full_cell")])
def test_mesh_equals_mesh_none(worlds, world, program):
    """Every rank's result equals the port's mesh=None run in this process:
    the uneven split (2, 2, 0), the 4x4 data plane (its 2 codeblocks per TB
    split apart from the TB rows on 3 ranks) and the full gNB slot with
    the sharded HARQ carry."""
    want = worlds["none"][program]
    exact, close = ((mh.FULL_CELL_EXACT, mh.FULL_CELL_CLOSE) if program == "full_cell"
                    else (mh.STEP_EXACT, mh.STEP_CLOSE))
    for rank in worlds["done"][world]["ranks"]:
        _hold(_outputs(rank, program), want, exact, close)


class _Mesh:
    """The two members of DeviceMesh that row_block reads."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)

    def size(self, d):
        return self.shape[d]


def test_row_block_is_nested_chunk():
    """Blocks follow torch.chunk nested in mesh order: 10 rows over (ue 2,
    cb 2) are 3, 2, 3, 2; 4 rows over 3 ranks 2, 2, 0."""
    m = _Mesh(("ue", "cb"), (2, 2))
    sizes = [np.subtract(*tmesh.row_block(10, m, ("ue", "cb"), c)[::-1])
             for c in [(0, 0), (0, 1), (1, 0), (1, 1)]]
    assert sizes == [3, 2, 3, 2]
    def chunks(x, k):       # torch.chunk, short of k chunks padded empty
        got = list(torch.chunk(x, k)) if x.numel() else []
        return got + [x[:0]] * (k - len(got))

    for n in range(13):
        want = [b for a in chunks(torch.arange(n), 2) for b in chunks(a, 2)]
        for i, c in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
            lo, hi = tmesh.row_block(n, m, ("ue", "cb"), c)
            assert list(range(lo, hi)) == want[i].tolist(), (n, c)
    m3 = _Mesh(("ue", "cb"), (3, 1))
    assert [tmesh.row_block(4, m3, ("ue",), (i, 0)) for i in range(3)] == \
        [(0, 2), (2, 4), (4, 4)]
    assert tmesh.row_block(7, None, ("ue",)) == (0, 7)


def test_spec_axes_and_splits():
    m = _Mesh(("cell", "ue", "cb"), (2, 1, 2))
    assert tmesh.spec_axes(m, ()) == ()
    assert tmesh.spec_axes(m, (("cell", "ue"),)) == ("cell", "ue")
    assert tmesh.spec_axes(m, ("cb",)) == ("cb",)
    with pytest.raises(ValueError):
        tmesh.spec_axes(m, (("cb", "ue"),))         # against the mesh order
    with pytest.raises(ValueError):
        tmesh.spec_axes(m, ("ue", "cb"))            # a second dim sharded
    assert tmesh._split(8, None, 2) == (4, 2) and tmesh._split(8, None, None) == (8, 1)
    with pytest.raises(ValueError):
        tmesh._split(8, 3, None)


def test_without_a_mesh_shard_is_a_reshape():
    x = torch.arange(24).reshape(4, 6)
    assert torch.equal(tsp.shard(x, None, ("ue",), (2, 2, 6)), x.reshape(2, 2, 6))
    assert tsp.unshard(x) is x
    assert not tmesh.is_dtensor(x)


def test_nccl_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="nccl"):
        tmesh.init_distributed(num_processes=1, process_id=0, backend="nccl",
                               init_method="file:///nonexistent")


def test_empty_shard_decodes_and_launches_nothing():
    """A rank with no codeblocks: K1's wrapper, K2's and decode() return
    empty results (no launch counted); the coding, the front, the back
    and the OFDM take a batch of no rows."""
    cuda_build.reset_launches()
    bg, zc = 2, 64
    n_full = tdc.get_graph(bg, zc).n_full
    for wire in (True, False):
        llr = torch.zeros((0, n_full), dtype=torch.int8 if wire else torch.float32)
        hard, ok, sweeps = tdc.decode_layered(llr, bg, zc, wire=wire)
        assert hard.shape == (0, tdc.get_graph(bg, zc).kb * zc)
        assert hard.dtype == torch.int8 and ok.shape == (0,) and sweeps.shape == (0,)
    assert tdc.decode_int8(torch.zeros((0, n_full)), bg, zc)[0].shape[0] == 0
    for schedule in ("wire_auto", "auto", "layered", "flooding", "layered_rolls_i8"):
        hard, ok = tdec.decode(torch.zeros((0, n_full)), bg, zc, schedule=schedule)
        assert hard.shape[0] == 0 and ok.dtype == torch.bool
    assert not cuda_build.LAUNCHES
    cell = mh.worker_cell()
    seg, rm = tsp._plans(cell)
    t = cell.timing
    syms = tsp._dl_code(torch.zeros((0, cell.derived_tbs()), dtype=torch.int8),
                        torch.arange(4), cell)
    assert syms.shape == (0, cell.g_total // cell.qm)
    assert tsp._dl_grid_ofdm(syms.reshape(0, 4, syms.shape[-1]), cell).shape == \
        (0, t.cp.total)
    llr, nv, cfo = tsp._ul_front(torch.zeros((0, t.cp.total), dtype=torch.complex64),
                                 torch.arange(4), cell)
    assert llr.shape == (0, 4, cell.g_total) and nv.shape == cfo.shape == (0, 4)
    pay, ok, soft = tsp._ul_back(llr.reshape(0, cell.g_total), cell,
                                 soft_buffer=torch.zeros((0, rm.n_cb), dtype=torch.int8),
                                 new_data=torch.zeros(0))
    assert pay.shape == (0, cell.derived_tbs()) and ok.shape == (0,)
    assert soft.shape == (0, rm.n_cb)
    c4 = mh.mimo4_cell()
    llr4, nv4, _ = tsp._ul_front_mimo(
        torch.zeros((0, 4, c4.timing.cp.total), dtype=torch.complex64),
        torch.arange(2), c4)
    assert llr4.shape == (0, 4 * c4.g_total) and nv4.shape == (0, 2)
