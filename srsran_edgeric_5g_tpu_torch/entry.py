"""The single-device entry point: the UL slot step of ``__graft_entry__.entry()``
on the port.

    python -m srsran_edgeric_5g_tpu_torch.entry [--device cuda|cpu]

runs ``fn`` once on the device and prints its output shapes, then runs
``parallel.dryrun`` (the counterpart of ``dryrun_multichip``) at a world of
every visible card (NCCL), or of one CPU rank over gloo with ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .device import resolve_device
from .parallel import dryrun
from .parallel import slot_pipeline as sp


def entry_cell() -> sp.CellConfig:
    """``__graft_entry__._cell(nof_ue=4, prb_per_ue=12, nfft=768,
    nof_prb=52)``: 10 MHz, 4 UEs x 12 PRB, 16QAM r0.4."""
    return sp.CellConfig(nof_prb=52, nfft=768, nof_ue=4, prb_per_ue=12,
                         modulation="qam16", target_rate=0.4)


def entry(device=None):
    """(fn, args): ``fn(rx_samples, rntis)`` is ``slot_pipeline.ul_slot`` at
    ``entry_cell()``, and ``args`` holds ``__graft_entry__.entry()``'s
    default_rng(0) complex draws as one complex64 tensor on ``device``
    (default: the card) and the RNTIs 0x4601 + arange(4)."""
    dev = resolve_device("cuda" if device is None else device)
    cell = entry_cell()
    total = cell.timing.cp.total
    rng = np.random.default_rng(0)
    rx = (rng.normal(size=total) * 0.1 + 1j * rng.normal(size=total) * 0.1)
    rx = torch.as_tensor(rx.astype(np.complex64), device=dev)
    rntis = torch.as_tensor(0x4601 + np.arange(cell.nof_ue), device=dev)

    def fn(rx_samples, rntis):
        return sp.ul_slot(rx_samples, rntis, cell, device=dev)

    return fn, (rx, rntis)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    fn, inputs = entry(args.device)
    out = fn(*inputs)
    print("entry() ran:", [tuple(x.shape) for x in out], flush=True)
    if args.device == "cuda":
        world = ["--world", str(torch.cuda.device_count())]
    else:
        world = ["--world", "1", "--device", "cpu", "--backend", "gloo"]
    return dryrun.main(world)


if __name__ == "__main__":
    sys.exit(main())
