"""Grant-layout churn of the PF scheduler, and what a layout's first use
costs the per-UE PHY, on the port.

Port of ``tools/sched_churn.py``: run the PF scheduler under Poisson
traffic and a CQI random walk for N slots (4 UEs, 106 PRB, RBG snap,
``numpy.random.default_rng(seed)``) and count the distinct grant layouts,
when each was first seen and the top-5 share.  Each layout is one
``HeteroCellProcessor`` configuration; where the reference compiles a
program per layout, the port builds plans and constant tensors per layout
and makes the rest (CRC tables, rate-match and decode plans, cuFFT plans)
at its first use.  ``--compile`` measures that per layout, most frequent
first: build ms (the constructor), first-use ms (``process_dl_slot`` +
``process_dl_rx_slot`` until the first host read) and, for the top 3,
warm ms per slot.

    python -m srsran_edgeric_5g_tpu_torch.tools.sched_churn [--slots 1000]
        [--compile] [--phy-slots 50] [--top N] [--device cuda|cpu]
"""

from __future__ import annotations

import sys
import time
from collections import Counter

import numpy as np
import torch

from ..device import resolve_device
from ..mac import scheduler as mac
from ..runtime.edgeric import cqi_from_sinr_db
from . import parser, write_record

MARKS = (10, 50, 100, 250, 500, 1000, 2000, 5000)


def run_scheduler(n_slots: int, nof_ue: int = 4, nof_prb: int = 106,
                  seed: int = 0):
    """-> (scheduler, Counter of layouts, {layout: first slot})."""
    rng = np.random.default_rng(seed)
    rntis = [0x4601 + u for u in range(nof_ue)]
    scfg = mac.SchedulerConfig(nof_prb=nof_prb, policy="time_pf",
                               rbg_size=mac.rbg_size_for_bwp(nof_prb))
    sched = mac.CellScheduler(scfg, rntis)
    sinr = {r: 25.0 for r in rntis}
    for r in rntis:
        sched.handle_csi(r, cqi_from_sinr_db(sinr[r]), sinr[r])
    mean_arrival = [2000 * (u + 1) for u in range(nof_ue)]

    layouts = Counter()
    first_seen = {}
    for slot in range(n_slots):
        for r, lam in zip(rntis, mean_arrival):
            sched.update_buffer(
                r, dl_bytes=sched.ues[r].dl_buffer + int(rng.poisson(lam)))
        grants = sched.run_slot()
        if not grants:
            continue
        key = tuple((g.rnti, g.start_prb, g.nof_prb, g.qm, g.target_rate)
                    for g in grants)
        if key not in layouts:
            first_seen[key] = slot
        layouts[key] += 1
        # CQI random walk (SINR wanders +-0.5 dB/TTI within 18..30 dB);
        # run_slot already drained buffers and rolled the PF averages.
        for r in rntis:
            sinr[r] = float(np.clip(sinr[r] + rng.uniform(-0.5, 0.5),
                                    18.0, 30.0))
            sched.handle_csi(r, cqi_from_sinr_db(sinr[r]), sinr[r])
    return sched, layouts, first_seen


def discovered(first_seen: dict, n_slots: int) -> dict[int, int]:
    """Layouts first seen before each mark up to ``n_slots``."""
    seen = sorted(first_seen.values())
    return {m: sum(1 for v in seen if v < m) for m in MARKS if m <= n_slots}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def layout_costs(layouts: Counter, device, top_n: int | None = None,
                 phy_slots: int = 50, warm_top: int = 3) -> list[dict]:
    """Per layout, most frequent first (the first ``top_n``): a
    ``HeteroCellProcessor``'s build ms, its first DL + DL-RX slot until the
    first host read (first-use ms), and for the first ``warm_top`` layouts
    the warm ms per slot over ``phy_slots`` slots."""
    from ..models.hetero_cell import HeteroCellProcessor
    from ..ran import numerology as num
    dev = resolve_device(device)
    t = num.slot_timing(nof_prb=106, nfft=1536)
    rng = np.random.default_rng(1)
    rows = []
    for i, (key, count) in enumerate(layouts.most_common(top_n or len(layouts))):
        grants = [mac.DlGrant(rnti=r, start_prb=sp_, nof_prb=np_, mcs=0, qm=qm,
                              target_rate=tr, tbs=0)
                  for (r, sp_, np_, qm, tr) in key]
        cfgs = mac.CellScheduler(mac.SchedulerConfig(nof_prb=106),
                                 [g.rnti for g in grants]).to_pdsch_configs(grants)
        _sync(dev)
        b0 = time.perf_counter()
        proc = HeteroCellProcessor(t, cfgs, device=dev)
        _sync(dev)
        b1 = time.perf_counter()
        payloads = [torch.as_tensor(rng.integers(0, 2, (1, n), dtype=np.int8),
                                    device=dev) for n in proc.tbs]
        c0 = time.perf_counter()
        outs = proc.process_dl_rx_slot(proc.process_dl_slot(payloads))
        outs[0][1].cpu()
        c1 = time.perf_counter()
        row = dict(layout=i, used=count, ues=len(key), build_ms=(b1 - b0) * 1e3,
                   first_use_ms=(c1 - c0) * 1e3,
                   tb_ok=all(bool(o[1].all()) for o in outs))
        if i < warm_top:
            s0 = time.perf_counter()
            for _ in range(phy_slots):
                outs = proc.process_dl_rx_slot(proc.process_dl_slot(payloads))
            outs[0][1].cpu()
            _sync(dev)
            row["warm_ms_per_slot"] = (time.perf_counter() - s0) / phy_slots * 1e3
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = parser("srsran_edgeric_5g_tpu_torch.tools.sched_churn", __doc__)
    ap.add_argument("--slots", type=int, default=1000)
    ap.add_argument("--compile", action="store_true",
                    help="build and run a HeteroCellProcessor per layout")
    ap.add_argument("--phy-slots", type=int, default=50)
    ap.add_argument("--top", type=int, default=None,
                    help="measure only the N most frequent layouts")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    _, layouts, first_seen = run_scheduler(args.slots)
    t_sched = time.perf_counter() - t0
    total = sum(layouts.values())
    lines = [f"{args.slots} PF slots (4 UE, 106 PRB, RBG snap, Poisson traffic, "
             f"CQI walk): {len(layouts)} distinct grant layouts over {total} "
             f"scheduled slots; scheduler host time "
             f"{t_sched / max(args.slots, 1) * 1e6:.0f} us/slot"]
    for m, n in discovered(first_seen, args.slots).items():
        lines.append(f"  layouts discovered by slot {m}: {n}")
    top5 = sum(c for _, c in layouts.most_common(5)) / max(total, 1)
    lines.append(f"  top-5 layouts cover {top5:.1%} of scheduled slots")
    for ln in lines:
        print(ln, flush=True)

    if args.compile:
        dev = resolve_device(args.device)
        print(f"building and running the DL + DL-RX per layout on {dev.type} "
              "(most frequent first):", flush=True)
        rows = layout_costs(layouts, dev, args.top, args.phy_slots)
        for r in rows:
            ln = (f"  layout {r['layout']} (used {r['used']}x, {r['ues']} UEs): "
                  f"build {r['build_ms']:.2f} ms, first use {r['first_use_ms']:.2f} ms"
                  + (f", warm {r['warm_ms_per_slot']:.2f} ms/slot"
                     if "warm_ms_per_slot" in r else ""))
            print(ln, flush=True)
            lines.append(ln)
        n = len(rows)
        first = sum(r["first_use_ms"] + r["build_ms"] for r in rows)
        warm = [r["warm_ms_per_slot"] for r in rows if "warm_ms_per_slot" in r]
        extra = first / n - (sum(warm) / len(warm) if warm else 0.0)
        ln = (f"build + first use: {first:.1f} ms for the top {n} layouts (mean "
              f"{first / n:.2f} ms, {extra:.2f} ms over a warm slot); "
              f"extrapolated {extra * len(layouts):.0f} ms for all "
              f"{len(layouts)}, amortized over {total} slots = "
              f"{extra * len(layouts) / max(total, 1):.3f} ms/slot")
        print(ln, flush=True)
        lines.append(ln)
        if not all(r["tb_ok"] for r in rows):
            print("a layout's first slot failed its CRC", file=sys.stderr)
            return 1
    write_record(args.out, lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
