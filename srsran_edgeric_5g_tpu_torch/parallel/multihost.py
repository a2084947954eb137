"""One rank of the multi-rank (multi-host) run of the sharded slot programs.

Port of ``tools/multihost_worker.py``.  Run one process per rank:

    python -m srsran_edgeric_5g_tpu_torch.parallel.multihost \\
        <rank> <world> <init_method> [--device cpu --backend gloo]
        [--programs cell,carrier] [--out DIR] [--repeat N]

``init_method`` is the rendezvous URL, a ``file://`` path under a
directory the caller names (every rank the same).  Ranks are grouped into
hosts by LOCAL_WORLD_SIZE (``mesh.host_of``).  Every rank draws the same
seeded inputs and runs the programs in the same order:

  cell       the single-cell DL+UL slot step (``dl_slot``, 30 dB AWGN,
             ``ul_slot``) on ``make_mesh_hostmajor(world // 2, 2)``, so the
             'ue' axis spans the hosts; CellConfig(nof_prb=24, nfft=512,
             nof_ue=4, prb_per_ue=6, 16QAM r0.4).  Its tally must hold
             all-gathers over 'ue' and over 'cb'.
  carrier    the multi-carrier step (``multi_cell_dl_slot_batch``, 30 dB,
             ``multi_cell_ul_slot_batch``) on ``make_host_mesh(n_cb=2)``,
             one carrier per host, 2 slots x 2 UEs each; CellConfig(
             nof_prb=8, nfft=128, nof_ue=2, prb_per_ue=4, 16QAM r0.4).  Its
             tally must hold no collective over 'host' (the final gather of
             the results comes after the tally is read).
  full_cell  the SISO full gNB slot (gnb_dl_slot_batch, ue_ul_slot_batch +
             25 dB, gnb_ul_slot_batch with the HARQ carry) at a 52-PRB
             2-UE cell, S = 6, on the (ue, cb) mesh of ``cell``, against the
             same calls with mesh=None.
  mimo4      the 4x4 data plane (dl_slot_batch_mimo, a 4x4 channel, 30 dB,
             ul_slot_batch_mimo), 24 PRB, 2 UEs, S = 2, on make_mesh(n_cb=2
             when the world is even), against mesh=None.
  uneven     the ``cell`` step on make_mesh(world, 1): with 3 ranks the 4
             UEs split 2, 2, 0 and one rank holds no row and no codeblock;
             against mesh=None.
  layout     the port's blocks are DTensor's own: for 0-12 rows split over
             'ue' and over ('ue', 'cb') of make_mesh(n_cb=2 when the world
             is even), DTensor's local shape and offset are ``row_block``'s
             and ``full_tensor()`` equals ``unshard`` (a functional
             collective: not under gloo with CUDA tensors).
  exit       the early stop over the ranks, on the inputs of ``--inputs``
             (an .npz the caller writes; ``exit_step``): each decode case's
             LLRs split at its bounds, one block per rank of
             make_mesh(1, world)'s 'cb' axis, decoded with the mesh's groups
             ("auto" for float LLRs, "wire_auto" for int8); and ``_ul_back``
             on that mesh.  The caller holds the results to mesh=None.

Each program asserts exact payloads after gathering its DTensors
(``slot_pipeline.unshard``, the counterpart of the reference's
``process_allgather``); against mesh=None
the bit-level outputs are equal and the floats within SAMPLE_ATOL and
FLOAT_RTOL.  The AWGN (absent from the reference's worker) makes the noise
estimate a measurement rather than round-off.  With ``--out`` every rank
writes its programs' outputs to DIR/rank<r>.npz.  Rank 0 prints
``MULTIHOST_OK procs=<hosts> ranks=<world> ...`` with each program's wall
seconds per step (the fastest of ``--repeat`` runs) and its tally.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import cuda_build
from ..ops.ldpc import decoder, decoder_cuda
from . import full_cell as fcm
from . import mesh as mm
from . import slot_pipeline as sp

SEED = 11
SNR_DB = 30.0
FC_SNR_DB = 25.0
# Against mesh=None: the sample tolerance of the port's FFT-order checks
# (tests/test_torch_timeblock.py); noise_var and cfo relative.
SAMPLE_ATOL = 1e-4
FLOAT_RTOL = 1e-4
PROGRAMS = ("cell", "carrier", "full_cell", "mimo4", "uneven", "layout", "exit")


def worker_cell() -> sp.CellConfig:
    return sp.CellConfig(nof_prb=24, nfft=512, nof_ue=4, prb_per_ue=6,
                         modulation="qam16", target_rate=0.4)


def carrier_cell() -> sp.CellConfig:
    return sp.CellConfig(nof_prb=8, nfft=128, nof_ue=2, prb_per_ue=4,
                         modulation="qam16", target_rate=0.4)


def mimo4_cell() -> sp.CellConfig:
    return sp.CellConfig(nof_prb=24, nfft=512, nof_ue=2, prb_per_ue=12,
                         modulation="qam16", target_rate=0.4, n_layers=4)


def small_full_cell() -> fcm.FullCellConfig:
    """tests/test_full_cell.py's small cell: 10 MHz, 52 PRB, 2 UEs."""
    return fcm.FullCellConfig(
        nof_prb=52, nfft=1024, nof_ue=2, dl_first_prb=2, dl_prb_per_ue=20,
        ul_first_prb=2, ul_prb_per_ue=20, coreset_start_prb=2,
        coreset_nof_prb=48, ssb_first_subcarrier=192, prach_freq_prb=46)


def awgn(x: np.ndarray, snr_db: float, rng) -> np.ndarray:
    """Complex numpy AWGN at ``snr_db`` below the mean power of ``x``."""
    var = float(np.mean(np.abs(x) ** 2)) * 10 ** (-snr_db / 10)
    noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    return (noise * np.sqrt(var / 2)).astype(np.complex64)


def mix_matrix(rng, n: int) -> np.ndarray:
    """A well-conditioned static n x n channel: random + DFT blend."""
    a = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))) / np.sqrt(2)
    f = np.exp(-2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n)
    return (0.35 * a + f / np.sqrt(n)).astype(np.complex64)


def _np(x) -> np.ndarray:
    """A result as a global numpy array: a DTensor gathered by
    ``slot_pipeline.unshard`` (c10d all_gather; ``DTensor.full_tensor()``
    gives the same, but its functional collective crashes the process
    under gloo with CUDA tensors, PERF.md)."""
    return sp.unshard(x).detach().cpu().numpy()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn, repeat: int = 1):
    """fn() ``repeat`` times, the tally reset before each: (the last
    result, the least wall seconds of a call, the last call's tally)."""
    best = math.inf
    for _ in range(repeat):
        _sync(dev)
        mm.reset_collectives()
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return out, best, mm.collective_stats()


def check_against(got: dict, want: dict, exact, close=(), samples=()) -> None:
    """Every key of ``exact`` equal, of ``close`` within FLOAT_RTOL of the
    peak, of ``samples`` within SAMPLE_ATOL."""
    for k in exact:
        if got[k].shape != want[k].shape or not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{k}: mesh result differs from mesh=None")
    for k in close:
        err = np.abs(got[k] - want[k]).max(initial=0.0)
        if err > FLOAT_RTOL * np.abs(want[k]).max(initial=0.0):
            raise AssertionError(f"{k}: off by {err} from mesh=None")
    for k in samples:
        err = np.abs(got[k] - want[k]).max(initial=0.0)
        if err > SAMPLE_ATOL:
            raise AssertionError(f"{k}: samples off by {err} from mesh=None")


# ------------------------------------------------------------------ programs

def cell_step(mesh, cell: sp.CellConfig, dev, rng, snr_db: float | None = SNR_DB,
              repeat: int = 1):
    """dl_slot -> AWGN (none when ``snr_db`` is None) -> ul_slot on
    ``mesh``; the global outputs, the step's seconds and its tally."""
    u = cell.nof_ue
    pay = rng.integers(0, 2, (u, cell.derived_tbs()), dtype=np.int8)
    rntis = np.arange(1, u + 1)

    def step():
        td = sp.unshard(sp.dl_slot(pay, rntis, cell, device=dev, mesh=mesh))
        rx = td
        if snr_db is not None:
            rx = td + torch.as_tensor(awgn(td.cpu().numpy(), snr_db, rng),
                                      device=dev)
        return td, sp.ul_slot(rx, rntis, cell, device=dev, mesh=mesh)

    (td, ul), seconds, tally = _timed(dev, step, repeat)
    out = dict(zip(("payload", "tb_ok", "noise_var", "cfo", "soft"),
                   (_np(x) for x in ul)), samples=_np(td), sent=pay)
    if not out["tb_ok"].all() or not np.array_equal(out["payload"], pay):
        raise AssertionError(f"cell step: {int((~out['tb_ok']).sum())} TBs "
                             "failed or payload mismatch")
    return out, seconds, tally


def carrier_step(mesh, cell: sp.CellConfig, dev, rng, slots: int = 2,
                 snr_db: float | None = SNR_DB, repeat: int = 1):
    """The multi-carrier step, the carriers on the mesh's leading axis (one
    per block): multi_cell_dl_slot_batch -> AWGN at ``snr_db`` below each
    carrier's own power -> multi_cell_ul_slot_batch."""
    nc, u = mesh.size(0), cell.nof_ue
    pay = rng.integers(0, 2, (nc, slots, u, cell.derived_tbs()), dtype=np.int8)
    rntis = (1 + np.arange(nc * u)).reshape(nc, u)
    lead = mm.spec_axes(mesh, (mesh.mesh_dim_names[0],))

    def step():
        p = sp.shard(torch.as_tensor(pay, device=dev), mesh, lead)
        td = sp.multi_cell_dl_slot_batch(p, rntis, cell, device=dev, mesh=mesh)
        rx = td
        if snr_db is not None:
            # Every rank draws every carrier's noise and adds its own
            # carriers' share: nothing crosses the carrier axis.
            noise = rng.normal(size=td.shape) + 1j * rng.normal(size=td.shape)
            k0, k1 = mm.row_block(nc, mesh, lead)
            local = td.to_local().cpu().numpy()
            var = np.mean(np.abs(local) ** 2, axis=(1, 2), keepdims=True) \
                * 10 ** (-snr_db / 10)
            rx_local = local + (noise[k0:k1] * np.sqrt(var / 2)).astype(np.complex64)
            rx = mm.wrap(torch.as_tensor(rx_local, device=dev), mesh, lead,
                         td.shape)
        return td, sp.multi_cell_ul_slot_batch(rx, rntis, cell, device=dev,
                                               mesh=mesh)

    (td, ul), seconds, tally = _timed(dev, step, repeat)
    out = dict(zip(("payload", "tb_ok", "noise_var", "cfo", "soft"),
                   (_np(x) for x in ul)), samples=_np(td), sent=pay)
    if not out["tb_ok"].all() or not np.array_equal(out["payload"], pay):
        raise AssertionError("carrier step: a TB failed or payload mismatch")
    return out, seconds, tally


def full_cell_step(mesh, fc: fcm.FullCellConfig, s_total: int, dev, rng,
                   num_iters: int = 3, snr_db: float = FC_SNR_DB,
                   repeat: int = 1):
    """The full gNB slot on ``mesh``: gnb_dl_slot_batch, the UE UL
    (through ``mix_matrix`` when fc.n_layers > 1) + AWGN, gnb_ul_slot_batch
    with a zero flat HARQ carry and new_data = 1, then a chase-combined
    reception fed the returned (sharded) carry with new_data = 0.  SISO or
    the *_mimo calls by fc.n_layers."""
    u, n_l = fc.nof_ue, fc.n_layers
    mimo = n_l > 1
    dl_n, dl_s = ((fc.dl_cell_mimo(), fc.dl_cell_ssb_mimo()) if mimo
                  else (fc.dl_cell(), fc.dl_cell_ssb()))
    seg, rm = sp._plans(fc.ul_cell(), 0)
    ins = dict(
        pay_n=rng.integers(0, 2, (len(fc.norm_slots(s_total)), u,
                                  dl_n.derived_tbs()), dtype=np.int8),
        pay_s=rng.integers(0, 2, (len(fc.ssb_slots(s_total)), u,
                                  dl_s.derived_tbs()), dtype=np.int8),
        dci=rng.integers(0, 2, (s_total, 2 * u, fc.dci_bits), dtype=np.int8),
        pbch=rng.integers(0, 2, (len(fc.ssb_slots(s_total)), 24), dtype=np.int8),
        pay_u=rng.integers(0, 2, (s_total, u, fc.ul_cell().derived_tbs()),
                           dtype=np.int8),
        ack=rng.integers(0, 2, (s_total, u, 2), dtype=np.int8),
        csi=rng.integers(0, 2, (len(fc.csi_slots(s_total)), u, fc.csi_bits),
                         dtype=np.int8))
    mix = mix_matrix(rng, n_l) if mimo else None
    gnb_dl, ue_ul, gnb_ul = ((fcm.gnb_dl_slot_batch_mimo, fcm.ue_ul_slot_batch_mimo,
                              fcm.gnb_ul_slot_batch_mimo) if mimo else
                             (fcm.gnb_dl_slot_batch, fcm.ue_ul_slot_batch,
                              fcm.gnb_ul_slot_batch))
    soft0 = torch.zeros((s_total * u * seg.c, rm.n_cb), dtype=torch.int8, device=dev)
    ones = torch.ones((s_total, u), device=dev)

    def step():
        td = sp.unshard(gnb_dl(ins["pay_n"], ins["pay_s"], ins["dci"], ins["pbch"],
                               fc, s_total, device=dev, mesh=mesh))
        ue = sp.unshard(ue_ul(ins["pay_u"], ins["ack"], ins["csi"], fc, s_total,
                              device=dev, mesh=mesh))
        if mimo:
            ue = torch.einsum("pl,slt->spt", torch.as_tensor(mix, device=dev), ue)
        rx = ue + torch.as_tensor(awgn(ue.cpu().numpy(), snr_db, rng), device=dev)
        res = gnb_ul(rx, fc, s_total, soft_in=soft0, new_data=ones,
                     num_iters=num_iters, soft_flat=True, device=dev, mesh=mesh)
        res2 = gnb_ul(rx, fc, s_total, soft_in=res["soft"], new_data=0 * ones,
                      num_iters=num_iters, soft_flat=True, device=dev, mesh=mesh)
        return td, ue, res, res2

    (td, ue, res, res2), seconds, tally = _timed(dev, step, repeat)
    out = {k: _np(v) for k, v in res.items()}
    out.update({f"combined_{k}": _np(res2[k]) for k in ("payload", "tb_ok", "soft")},
               samples=_np(td), ue_samples=_np(ue), sent=ins["pay_u"])
    det = out["prach_detected"]
    if not (out["tb_ok"].all() and np.array_equal(out["payload"], ins["pay_u"])
            and out["combined_tb_ok"].all()
            and np.array_equal(out["ack_bits"], ins["ack"])
            and det[:, 7].all() and det.sum() == det.shape[0]):
        raise AssertionError("full cell: a PUSCH TB, an ACK or the PRACH "
                             "preamble was not recovered")
    return out, seconds, tally


FULL_CELL_EXACT = ("payload", "tb_ok", "soft", "ack_bits", "csi_bits", "csi_ok",
                   "prach_detected", "prach_delay", "combined_payload",
                   "combined_tb_ok", "combined_soft")
FULL_CELL_CLOSE = ("noise_var", "cfo", "ack_metric", "srs_h", "srs_snr_db",
                   "prach_metric")


def mimo_step(mesh, cell: sp.CellConfig, dev, rng, slots: int = 2,
              snr_db: float | None = SNR_DB, repeat: int = 1):
    """The multi-layer data plane on ``mesh``: dl_slot_batch_mimo, the
    static ``mix_matrix`` channel (+ AWGN unless ``snr_db`` is None),
    ul_slot_batch_mimo."""
    u, n_l = cell.nof_ue, cell.n_layers
    pay = rng.integers(0, 2, (slots, u, cell.derived_tbs()), dtype=np.int8)
    rntis = np.arange(1, u + 1)
    mix = torch.as_tensor(mix_matrix(rng, n_l), device=dev)

    def step():
        td = sp.unshard(sp.dl_slot_batch_mimo(pay, rntis, cell, device=dev,
                                              mesh=mesh))
        rx = torch.einsum("pl,slt->spt", mix, td)
        if snr_db is not None:
            rx = rx + torch.as_tensor(awgn(rx.cpu().numpy(), snr_db, rng),
                                      device=dev)
        return td, sp.ul_slot_batch_mimo(rx, rntis, cell, device=dev, mesh=mesh)

    (td, ul), seconds, tally = _timed(dev, step, repeat)
    out = dict(zip(("payload", "tb_ok", "noise_var", "cfo", "soft"),
                   (_np(x) for x in ul)), samples=_np(td), sent=pay)
    if not out["tb_ok"].all() or not np.array_equal(out["payload"], pay):
        raise AssertionError(f"{n_l}-layer data plane: a TB failed or "
                             "payload mismatch")
    return out, seconds, tally


STEP_EXACT = ("payload", "tb_ok", "soft")
STEP_CLOSE = ("noise_var", "cfo")


# The exit program's path case: two TBs of a 24-PRB 64QAM r0.75 cell (BG1
# Zc 320, two codeblocks each) at 16.5 dB, the waterfall, from EXIT_SEED's
# draw of EXIT_DRAW TBs, 7 sweeps.  EXIT_TBS[0] goes to rank 0: its first
# codeblock meets parity after 6 sweeps, misses it after 7, meets it after
# 8; EXIT_TBS[1] to rank 1: a codeblock of it first meets parity after 7.
# A rank that stopped on its own share would stop rank 0 after 6 sweeps
# with every codeblock meeting parity; the batch runs 7.
EXIT_CELL = dict(nof_prb=24, nfft=512, nof_ue=1, prb_per_ue=24,
                 modulation="qam64", target_rate=0.75)
EXIT_SNR_DB = 16.5
EXIT_SEED = (0, 1650)
EXIT_DRAW = 512
EXIT_TBS = (130, 2)
EXIT_ITERS = 7


def wire_llrs(cell: sp.CellConfig, n_tb: int, snr_db: float, rng) -> torch.Tensor:
    """(n_tb, G) wire LLRs of random payloads through ``cell``'s coding
    chain (segment, encode, rate match, QAM) and AWGN at ``snr_db`` (numpy
    draws: payloads, then noise), demapped and wire-quantised as the UL
    front does; unscrambled, so they are ``_ul_back``'s input."""
    from ..ops import modulation
    from ..ops.ldpc import encoder, rate_match, segmenter
    seg, rm = sp._plans(cell)
    pay = rng.integers(0, 2, (n_tb, cell.derived_tbs()), dtype=np.int8)
    cw = encoder.encode(segmenter.segment_tb(torch.as_tensor(pay), seg), seg.bg, seg.zc)
    syms = modulation.modulate(rate_match.rate_match(cw, rm), cell.modulation).numpy()
    nv = 10 ** (-snr_db / 10)
    y = syms + (rng.normal(size=syms.shape) + 1j * rng.normal(size=syms.shape)) \
        * np.sqrt(nv / 2)
    llr = modulation.demodulate_soft(torch.as_tensor(y.astype(np.complex64)),
                                     torch.tensor(nv), cell.modulation, quantize=False)
    return modulation.wire_quantize(llr, cell.modulation).reshape(n_tb, -1)


def exit_inputs() -> dict:
    """The 'exit' program's inputs for 2 ranks (``exit_step``): decode
    cases "auto" (tools.bler_sweep's MCS 24, 16 dB point, codeblocks 121
    and 124, one per rank), "wire" (121 and 122 as int8 wire LLRs) and
    "empty" (121 and 124 on rank 0, none on rank 1), 8 sweeps; and the
    path case (EXIT_CELL's TBs EXIT_TBS)."""
    from ..tools import bler_sweep
    seg, _, full = bler_sweep.point_input(24, 16.0, device="cpu")
    meta = np.array([seg.bg, seg.zc, bler_sweep.NUM_ITERS])
    pair = full[[121, 124]].numpy()
    cell = sp.CellConfig(**EXIT_CELL)
    llr = wire_llrs(cell, EXIT_DRAW, EXIT_SNR_DB, np.random.default_rng(EXIT_SEED))
    return {"auto/llrs": pair, "auto/bounds": np.array([0, 1, 2]), "auto/meta": meta,
            "wire/llrs": full[[121, 122]].clamp(-64, 64).to(torch.int8).numpy(),
            "wire/bounds": np.array([0, 1, 2]), "wire/meta": meta,
            "empty/llrs": pair, "empty/bounds": np.array([0, 2, 2]), "empty/meta": meta,
            "path/llr": llr[list(EXIT_TBS)].numpy(),
            "path/cell": np.array(json.dumps(EXIT_CELL)),
            "path/num_iters": np.array(EXIT_ITERS)}


def exit_step(inputs, world: int, dev: torch.device) -> dict:
    """The early stop over the ranks of make_mesh(1, world)'s 'cb' axis.

    ``inputs`` (an .npz's arrays): per decode case ``<name>/llrs`` (B, n),
    ``<name>/bounds`` (world + 1,) the row split (rank at 'cb' coordinate c
    takes rows [bounds[c], bounds[c + 1])) and ``<name>/meta`` (bg, zc,
    num_iters); and, for the path, ``path/llr`` (B_tb, G) wire LLRs,
    ``path/cell`` (CellConfig's fields as JSON) and ``path/num_iters``.
    Returns each case's local hard bits, ok and K1 launches, and the path's
    gathered payload and tb_ok with the hard bits and ok of the decode
    ``_ul_back`` made on this rank (its codeblock block)."""
    mesh = mm.make_mesh(n_ue=1, n_cb=world, device_type=dev.type)
    groups = [mesh.get_group(mm.CB_AXIS)]
    c = mm.coordinate(mesh)[1]
    out = {}
    for key in sorted(k for k in inputs if k.endswith("/llrs")):
        name = key[:-len("/llrs")]
        bounds = inputs[f"{name}/bounds"]
        bg, zc, n = (int(v) for v in inputs[f"{name}/meta"])
        x = torch.as_tensor(inputs[key][bounds[c]:bounds[c + 1]], device=dev)
        cuda_build.reset_launches()
        hard, ok = decoder.decode(x, bg, zc, n, process_groups=groups,
                                  schedule="wire_auto" if x.dtype == torch.int8
                                  else "auto")
        _sync(dev)
        out.update({f"{name}/hard": hard.cpu().numpy(), f"{name}/ok": ok.cpu().numpy(),
                    f"{name}/launches": np.array(cuda_build.LAUNCHES[decoder_cuda.KERNEL])})
    if "path/llr" in inputs:
        cell = sp.CellConfig(**json.loads(str(inputs["path/cell"])))
        decodes, decode = [], decoder.decode

        def recorded(*args, **kw):     # the decode _ul_back makes, kept
            decodes.append(decode(*args, **kw))
            return decodes[-1]

        decoder.decode = recorded
        try:
            pay, tb_ok, _ = sp._ul_back(torch.as_tensor(inputs["path/llr"], device=dev),
                                        cell, num_iters=int(inputs["path/num_iters"]),
                                        mesh=mesh)
        finally:
            decoder.decode = decode
        (hard, ok), = decodes
        out.update({"path/payload": _np(pay), "path/tb_ok": _np(tb_ok),
                    "path/hard": hard.cpu().numpy(), "path/ok": ok.cpu().numpy()})
    return out


# ------------------------------------------------------------------ the rank

def _even_cb(world: int) -> int:
    return 2 if world >= 4 and world % 2 == 0 else 1


def describe(mesh) -> dict:
    """A mesh's axis names and rank grid, for the report."""
    return {"names": list(mesh.mesh_dim_names), "ranks": mesh.mesh.tolist()}


def run_program(name: str, world: int, dev: torch.device, repeat: int = 1,
                inputs=None):
    """One named program on this rank, its step run ``repeat`` times:
    (outputs, least seconds per step, tally, the mesh it ran on);
    ``inputs`` (the .npz of ``--inputs``) feeds 'exit'."""
    dt = dev.type
    seed = SEED + PROGRAMS.index(name)
    if name == "cell":
        n_cb = _even_cb(world)
        mesh = mm.make_mesh_hostmajor(world // n_cb, n_cb, device_type=dt)
        out, sec, tally = cell_step(mesh, worker_cell(), dev,
                                    np.random.default_rng(seed), repeat=repeat)
        if not (tally.get(mm.UE_AXIS, {}).get("count") and
                (n_cb == 1 or tally.get(mm.CB_AXIS, {}).get("count"))):
            raise AssertionError(f"cell step: no all-gather over ue/cb: {tally}")
        return out, sec, tally, describe(mesh)
    if name == "carrier":
        mesh = mm.make_host_mesh(n_cb=2 if (world // _hosts(world)) % 2 == 0 else 1,
                                 device_type=dt)
        out, sec, tally = carrier_step(mesh, carrier_cell(), dev,
                                       np.random.default_rng(seed), repeat=repeat)
        if mm.HOST_AXIS in tally:
            raise AssertionError(f"carrier step crossed the host axis: {tally}")
        return out, sec, tally, describe(mesh)
    if name == "exit":
        if inputs is None:
            raise ValueError("program 'exit' decodes the arrays of --inputs")
        out, sec, tally = _timed(dev, lambda: exit_step(inputs, world, dev))
        return out, sec, tally, {"names": [mm.UE_AXIS, mm.CB_AXIS],
                                 "ranks": [list(range(world))]}
    if name == "layout":
        mesh = mm.make_mesh(n_cb=_even_cb(world), device_type=dt)
        out, sec, tally = _timed(dev, lambda: layout_check(mesh))
        return out, sec, tally, describe(mesh)
    if name == "uneven":
        mesh = mm.make_mesh(n_ue=world, n_cb=1, device_type=dt)
        step = lambda m: cell_step(m, worker_cell(), dev,
                                   np.random.default_rng(seed), repeat=repeat)
        exact, close = STEP_EXACT, STEP_CLOSE
    elif name == "mimo4":
        mesh = mm.make_mesh(n_cb=_even_cb(world), device_type=dt)
        step = lambda m: mimo_step(m, mimo4_cell(), dev,
                                   np.random.default_rng(seed), repeat=repeat)
        exact, close = STEP_EXACT, STEP_CLOSE
    elif name == "full_cell":
        mesh = mm.make_mesh(n_cb=_even_cb(world), device_type=dt)
        step = lambda m: full_cell_step(m, small_full_cell(), 6, dev,
                                        np.random.default_rng(seed), repeat=repeat)
        exact, close = FULL_CELL_EXACT, FULL_CELL_CLOSE
    else:
        raise ValueError(f"unknown program {name!r}; valid: {PROGRAMS}")
    out, sec, tally = step(mesh)
    ref, _, _ = step(None)
    check_against(out, ref, exact, close,
                  [k for k in out if k.endswith("samples")])
    return out, sec, tally, describe(mesh)


def layout_check(mesh) -> dict:
    """DTensor's own split of 0-12 rows against ``row_block`` and
    ``full_tensor()`` against ``unshard``, for each spec of ``mesh``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    dev = mm.rank_device(mesh.device_type)
    checked = 0
    for spec in ((mm.UE_AXIS,), ((mm.UE_AXIS, mm.CB_AXIS),)):
        axes = mm.spec_axes(mesh, spec)
        for n in range(13):
            x = torch.arange(n * 3, dtype=torch.float32, device=dev).reshape(n, 3)
            d = sp.shard(x, mesh, spec)
            lo, hi = mm.row_block(n, mesh, axes)
            shape, offset = compute_local_shape_and_global_offset(
                d.shape, mesh, d.placements)
            if tuple(shape) != (hi - lo, 3) or (hi > lo and offset[0] != lo):
                raise AssertionError(f"{spec} n={n}: DTensor's block {shape} at "
                                     f"{offset}, row_block's [{lo}, {hi})")
            if not (torch.equal(d.full_tensor(), x) and torch.equal(sp.unshard(d), x)):
                raise AssertionError(f"{spec} n={n}: gathered rows differ")
            checked += 1
    return {"checked": np.array(checked)}


def _hosts(world: int) -> int:
    return len({mm.host_of(r) for r in range(world)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("init_method")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--programs", default="cell,carrier")
    ap.add_argument("--out", default=None)
    ap.add_argument("--inputs", default=None,
                    help="an .npz of the 'exit' program's inputs (exit_step)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="run each step this many times, report the fastest")
    args = ap.parse_args(argv)
    names = [n for n in args.programs.split(",") if n]
    mm.init_distributed(num_processes=args.world, process_id=args.rank,
                        backend=args.backend, init_method=args.init_method)
    try:
        dev = mm.rank_device(args.device)
        inputs = None if args.inputs is None else dict(np.load(args.inputs))
        saved, summary = {}, {}
        for name in names:
            out, sec, tally, mesh = run_program(name, args.world, dev, args.repeat,
                                                inputs)
            saved.update({f"{name}/{k}": v for k, v in out.items()})
            summary[name] = {"seconds": sec, "collectives": tally, "mesh": mesh}
        if args.out:
            np.savez(os.path.join(args.out, f"rank{args.rank}.npz"),
                     summary=np.array(json.dumps(summary)), **saved)
        dist.barrier()
        if args.rank == 0:
            print(f"MULTIHOST_OK procs={_hosts(args.world)} ranks={args.world} "
                  f"device={dev.type} backend={args.backend} "
                  f"{json.dumps(summary)}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
