"""Multi-rank dry run of the sharded slot programs at the real 20 MHz shapes.

Port of ``__graft_entry__.dryrun_multichip``.  Run it as

    python -m srsran_edgeric_5g_tpu_torch.parallel.dryrun --world N \\
        [--device cpu --backend gloo]

which starts its N ranks itself (one process each, rendezvous through a
``file://`` store in a fresh temporary directory) and waits for them.
Every rank runs, on the same seeded inputs:

  1. the single-cell DL+UL slot step on make_mesh(N // n_cb, n_cb), n_cb =
     2 for an even N > 1: max(N, 2) UEs x 104 // nof_ue PRB at 106 PRB,
     nfft 1536, 64QAM r0.5, noiseless, payload-exact;
  2. the time-block stream: 2N slots of random grids modulated and
     demodulated in N blocks on the rank's own device list (``timeblock``
     takes devices, not a mesh), the DFT windows shifted; every slot but
     the first within 1e-3 of the grids;
  3. with N >= 4 and even, the multi-carrier step on make_cell_mesh(2,
     N // 4, 2): 2 carriers x 2 slots x 2 UEs at 8 PRB, payload-exact;
  4. the full gNB slot, SISO and 2x2 MIMO, at FullCellConfig() (20 MHz, 106
     PRB, 4 UEs, 64QAM), S = 10 with the HARQ carry, on the (ue, cb) mesh of
     step 1: PUSCH payload-exact, the ACKs exact, PRACH preamble 7 alone;
  5. the 4x4 data plane (4 UEs x 24 PRB at 106 PRB, 16QAM r0.4, 2 slots)
     through a static 4x4 channel, noiseless, payload-exact.

Rank 0 prints one line per program with its wall seconds and its tally of
all-gathers per mesh axis (``mesh.collective_stats``), then
``dryrun(N): ... ok``.  ``run`` does the same in a process that has
already joined a process group (``chip_smoke.py`` runs it as a world of 1
over NCCL).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from . import full_cell as fcm
from . import mesh as mm
from . import multihost as mh
from . import slot_pipeline as sp
from . import timeblock

SEED = 1
FULL_SLOTS = 10          # one SSB + SRS + PRACH period
CHILD_WAIT_S = 1200


def dryrun_cell(n: int) -> sp.CellConfig:
    """The real 20 MHz geometry with one UE row per 'ue' rank."""
    nof_ue = max(n, 2)
    return sp.CellConfig(nof_prb=106, nfft=1536, nof_ue=nof_ue,
                         prb_per_ue=104 // nof_ue if nof_ue <= 8 else 1,
                         modulation="qam64", target_rate=0.5)


def mimo4_cell() -> sp.CellConfig:
    return sp.CellConfig(nof_prb=106, nfft=1536, nof_ue=4, prb_per_ue=24,
                         modulation="qam16", target_rate=0.4, n_layers=4)


def time_block_stream(n: int, dev: torch.device, rng) -> float:
    """2n slots of random 20 MHz grids through n time blocks on ``dev``,
    the windows min(cp) // 2 early; the largest error against the grids
    past slot 0."""
    t = dryrun_cell(n).timing
    shape = (2 * n, t.nsymb, t.nof_subc)
    grids = torch.as_tensor((rng.normal(size=shape) + 1j * rng.normal(size=shape)
                             ).astype(np.complex64), device=dev)
    devices = timeblock.make_time_mesh(devices=[dev] * n)
    td = timeblock.modulate_stream_sharded(grids, t, devices)
    back = timeblock.demodulate_stream_sharded(td, t, devices,
                                               shift=min(t.cp.cp) // 2)
    err = float((back[1:] - grids[1:]).abs().max())
    if err >= 1e-3:
        raise AssertionError(f"time-block round trip off by {err}")
    return err


def run(n: int, dev: torch.device) -> dict:
    """The dry run's programs on this rank of a world of ``n``; returns
    {program: {"seconds", "collectives", ...}} and raises on any failed
    check.  The process group must be up."""
    rng = np.random.default_rng(SEED)
    n_cb = 2 if n % 2 == 0 and n > 1 else 1
    mesh = mm.make_mesh(n_ue=n // n_cb, n_cb=n_cb, device_type=dev.type)
    report = {}

    def note(name, sec, tally, **extra):
        report[name] = {"seconds": sec, "collectives": tally, **extra}

    cell = dryrun_cell(n)
    _, sec, tally = mh.cell_step(mesh, cell, dev, rng, snr_db=None)
    note("cell", sec, tally, ues=cell.nof_ue, prb_per_ue=cell.prb_per_ue,
         tbs=cell.derived_tbs(), mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)))
    note("time_block", None, {}, max_err=time_block_stream(n, dev, rng))
    if n % 2 == 0 and n >= 4:
        cmesh = mm.make_cell_mesh(2, n // 4, 2, device_type=dev.type)
        _, sec, tally = mh.carrier_step(cmesh, mh.carrier_cell(), dev, rng,
                                        snr_db=None)
        if mm.CELL_AXIS in tally:
            raise AssertionError(f"carrier step crossed the cell axis: {tally}")
        note("carrier", sec, tally,
             mesh=dict(zip(cmesh.mesh_dim_names, cmesh.shape)))
    for n_l in (1, 2):
        fc = fcm.FullCellConfig(n_layers=n_l)
        _, sec, tally = mh.full_cell_step(mesh, fc, FULL_SLOTS, dev, rng)
        note("full_cell" if n_l == 1 else "mimo_full_cell", sec, tally,
             slots=FULL_SLOTS)
    _, sec, tally = mh.mimo_step(mesh, mimo4_cell(), dev, rng, snr_db=None)
    note("mimo4", sec, tally)
    return report


def _child(args) -> int:
    mm.init_distributed(num_processes=args.world, process_id=args.rank,
                        backend=args.backend, init_method=args.init_method)
    try:
        report = run(args.world, mm.rank_device(args.device))
        dist.barrier()
        if args.rank == 0:
            for name, r in report.items():
                print(f"dryrun {name}: {json.dumps(r)}", flush=True)
            print(f"dryrun({args.world}): {', '.join(report)} ok", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _child(args)
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", __spec__.name, "--world", str(args.world),
             "--device", args.device, "--backend", args.backend,
             "--rank", str(r), "--init-method", init])
            for r in range(args.world)]
        deadline = time.monotonic() + CHILD_WAIT_S
        rcs = []
        try:
            for p in procs:
                rcs.append(p.wait(timeout=max(0.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            print(f"dryrun: a rank ran past {CHILD_WAIT_S} s", file=sys.stderr)
            rcs.append(124)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return max(abs(rc) for rc in rcs)


if __name__ == "__main__":
    sys.exit(main())
