"""Standalone gNB-PHY loopback app on the port: config -> cell processor ->
IQ bridge.

Port of the default (unscheduled) mode of ``tools/run_loopback_app.py``, the
apps/gnb counterpart in miniature: loads a YAML (or default) PhyConfig,
builds a CellProcessor on the card, and runs N slots of DL -> radio -> UL
loopback through the native ZMQ IQ bridge (the gNB TX REP server looped back
to the gNB RX REQ client, standing in for the GNU Radio flowgraph and the
UEs), printing per-slot metrics like the reference's stdout plotter.

Usage:
    python -m srsran_edgeric_5g_tpu_torch.loopback_app [config.yml]
        [--slots N] [--snr dB] [--port P] [--trace FILE] [--run-ahead K]
        [--device cuda|cpu]

The slot loop itself is ``run_slot_loop``, which takes the radio as a
callable, so a caller can drive the same loop with another radio (an
in-process AWGN channel on the card, for instance).  The scheduled modes of
the reference app (``--sched``, ``--edgeric``, ``--bcch``, ``--rach``,
``--ul-traffic`` and the fades) need the MAC and RIC layers, which this
package does not have yet: they exit with an error.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from .runtime.events import (RadioEventNotifier, SlotClock, SlotDeadline,
                             fail_open)

NOT_PORTED = ("--sched, --edgeric, --bcch, --rach, --ul-traffic and the fades "
              "need the MAC and RIC layers, which the port does not have yet "
              "(ROADMAP.md Queue A item 3)")


@dataclasses.dataclass
class LoopResult:
    nof_tbs: int            # slots * UEs
    ok_count: int           # TBs that passed CRC
    exact_count: int        # TBs that passed CRC with the sent payload
    seconds: float          # wall time of the whole loop
    latency_ms: list[float]  # per slot: UL submit -> results on the host


def run_slot_loop(proc, radio: Callable, n_slots: int,
                  payloads: Callable[[int], torch.Tensor], run_ahead: int = 2,
                  notifier: RadioEventNotifier | None = None,
                  log: Callable[[str], None] = print) -> LoopResult:
    """The app's pipelined slot loop.

    DL for up to ``run_ahead`` future slots is submitted before the current
    slot's radio round trip, and UL results are read ``depth`` (2) slots
    late — the streaming mode the reference gets from
    nof_slot_tti_in_advance and its lower-PHY executors
    (lower_phy_baseband_processor.h:40-197).  ``run_ahead`` 0 is the fully
    serial loop (the same code path).

    ``radio(slot, td)`` carries one slot's DL samples and returns the
    received block, or None on underflow (counted; the slot's UL is
    skipped).  ``payloads(slot)`` gives the slot's (U, TBS) bits.  A slot
    whose UL processing raises is counted as an error and dropped
    (``fail_open``); a request for a slot already passed is counted LATE and
    dropped; a slot over its real-time budget (a generous host-IO run-ahead
    of 5000 slots: the loop is a functional loopback, not the benchmark) is
    counted LATE.  Every event goes to ``notifier``.
    """
    t = proc.cell.timing
    notifier = notifier or RadioEventNotifier()
    slot_clock = SlotClock(notifier)
    deadline = SlotDeadline(t.cp.total / t.srate, run_ahead=5000,
                            notifier=notifier)
    run_ahead = max(0, run_ahead)
    depth = 2 if run_ahead else 0
    dl_q: deque = deque()   # (slot, deadline token, payloads, DL samples)
    ul_q: deque = deque()   # (slot, token, payloads, submit time, UL result)
    lat_ms: list[float] = []
    counts = {"ok": 0, "exact": 0}
    next_dl = 0
    t0 = time.time()

    def dispatch_dl():
        nonlocal next_dl
        slot = next_dl
        next_dl += 1
        if slot_clock.advance(slot) is None:
            return  # stale request: counted LATE, dropped (puxch rule)
        pay = payloads(slot)
        dl_q.append((slot, deadline.start(), pay, proc.process_dl_slot(pay)))

    def sync_ul(min_inflight):
        while len(ul_q) > min_inflight:
            slot, tok, pay, t_sub, res = ul_q.popleft()
            if res is None:
                continue  # UL processing error: counted, the cell stays up
            hat, tb_ok = res
            exact = tb_ok & torch.all(hat == pay.to(hat.device), dim=-1)
            okv, exv = torch.stack([tb_ok, exact]).cpu().numpy()
            counts["ok"] += int(okv.sum())
            counts["exact"] += int(exv.sum())
            if not okv.all():
                log(f"slot {slot}: CRC failures {np.nonzero(~okv)[0]}")
            deadline.finish(slot, tok)
            lat_ms.append((time.time() - t_sub) * 1e3)

    while next_dl < n_slots or dl_q:
        while next_dl < n_slots and len(dl_q) <= run_ahead:
            dispatch_dl()
        if not dl_q:
            break
        slot, tok, pay, td = dl_q.popleft()
        got = radio(slot, td)
        if got is None:
            # Radio underflow: count the event and skip the slot's UL (the
            # reference notifies and keeps the cell alive).
            notifier.on_underflow(slot)
            continue
        res = fail_open(notifier, slot, lambda: proc.process_ul_slot(got))
        ul_q.append((slot, tok, pay, time.time(), res))
        sync_ul(depth)
    sync_ul(0)
    return LoopResult(nof_tbs=n_slots * proc.cell.nof_ue,
                      ok_count=counts["ok"], exact_count=counts["exact"],
                      seconds=time.time() - t0, latency_ms=lat_ms)


def _radio_roundtrip(tx, rx, samples: np.ndarray, snr_db: float,
                     rng: np.random.Generator, total: int):
    """Push DL samples through the ZMQ bridge with AWGN, pull them back.
    Returns the received block or None on underflow."""
    nv = float((np.abs(samples) ** 2).mean()) * 10 ** (-snr_db / 10)
    noise = rng.normal(size=samples.shape) + 1j * rng.normal(size=samples.shape)
    tx.push(samples + (noise * np.sqrt(nv / 2)).astype(np.complex64))
    got = np.empty(0, np.complex64)
    deadline = time.time() + 5.0
    while len(got) < total and time.time() < deadline:
        chunk = rx.pull(total - len(got))
        got = np.concatenate([got, chunk]) if len(chunk) else got
        if len(got) < total:
            time.sleep(0.0005)
    return got if len(got) >= total else None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m srsran_edgeric_5g_tpu_torch.loopback_app")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--slots", type=int, default=20)
    ap.add_argument("--snr", type=float, default=25.0)
    ap.add_argument("--port", type=int, default=47655)
    ap.add_argument("--trace", default=None, help="write chrome trace JSON")
    ap.add_argument("--run-ahead", type=int, default=2, dest="run_ahead",
                    help="slots of DL run-ahead (the reference's "
                         "nof_slot_tti_in_advance): DL for slot s+K is "
                         "submitted before slot s finishes UL, and UL "
                         "results are read two slots late.  0 = fully "
                         "serial slot loop")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the PHY (default cuda; cpu runs "
                         "the plain versions)")
    # The reference app's scheduled modes: refused here (NOT_PORTED).
    ap.add_argument("--edgeric", action="store_true")
    ap.add_argument("--bcch", action="store_true")
    ap.add_argument("--ul-traffic", type=int, default=0, dest="ul_traffic")
    ap.add_argument("--ul-fade", type=int, default=-1, dest="ul_fade")
    ap.add_argument("--ul-fade-snr", type=float, default=3.0, dest="ul_fade_snr")
    ap.add_argument("--dl-fade", type=int, default=-1, dest="dl_fade")
    ap.add_argument("--dl-fade-snr", type=float, default=3.0, dest="dl_fade_snr")
    ap.add_argument("--rach", type=int, default=0)
    ap.add_argument("--sched", choices=("off", "rr", "pf"), default="off")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if (args.sched != "off" or args.edgeric or args.bcch or args.rach
            or args.ul_traffic or args.ul_fade >= 0 or args.dl_fade >= 0):
        ap.error(NOT_PORTED)

    from . import config as cfg_mod
    from .device import resolve_device
    from .models.cell_processor import CellProcessor
    from .runtime import IqRxClient, IqTxServer
    from .utils.metrics import StdoutSink
    from .utils.tracing import l1_tracer

    dev = resolve_device(args.device)
    cfg = cfg_mod.load(args.config) if args.config else cfg_mod.PhyConfig()
    cell = cfg.cell_config()
    proc = CellProcessor(cell, pci=cfg.pci, device=dev)
    proc.metrics.add_sink(StdoutSink(every=max(1, args.slots // 10)))
    if args.trace:
        l1_tracer.enable()

    t = cell.timing
    addr = f"tcp://127.0.0.1:{args.port}"
    tx = IqTxServer(addr, chunk=t.cp.total)
    rx = IqRxClient(addr.replace("*", "localhost"), chunk=t.cp.total)

    # Failure detection: radio event counters (run_slot_loop adds the
    # skipped-slot tracking and the real-time budget check).
    notifier = RadioEventNotifier(log=lambda s: print(f"[radio] {s}", flush=True))

    rng = np.random.default_rng(0)
    tbs = proc.tbs
    print(f"cell: {cfg.bandwidth_mhz} MHz / {cfg.nof_prb} PRB, "
          f"{cell.nof_ue} UEs x {cell.prb_per_ue} PRB, TBS {tbs}, "
          f"srate {t.srate/1e6:.2f} Msps, device {dev}", flush=True)

    def payloads(slot):
        return torch.as_tensor(rng.integers(0, 2, (cell.nof_ue, tbs),
                                            dtype=np.int8), device=dev)

    def radio(slot, td):
        got = _radio_roundtrip(tx, rx, td.cpu().numpy(), args.snr, rng,
                               t.cp.total)
        return None if got is None else torch.as_tensor(got, device=dev)

    try:
        res = run_slot_loop(proc, radio, args.slots, payloads,
                            run_ahead=args.run_ahead, notifier=notifier,
                            log=lambda s: print(s, flush=True))
    finally:
        rx.stop()
        tx.stop()

    n = res.nof_tbs
    tp = proc.metrics.throughput_mbps()
    dt = res.seconds
    print(f"done: {args.slots} slots in {dt:.2f}s "
          f"({args.slots / dt:.1f} slot/s incl. host IO), "
          f"TB success {res.ok_count}/{n}", flush=True)
    if res.latency_ms:
        print(f"slot latency (radio-roundtrip submit -> UL decoded, "
              f"run-ahead {max(0, args.run_ahead)}): p50 "
              f"{float(np.percentile(res.latency_ms, 50)):.2f} ms / p99 "
              f"{float(np.percentile(res.latency_ms, 99)):.2f} ms", flush=True)
    print(f"radio events: {notifier.events.as_dict()}", flush=True)
    print("throughput (Mbit/s @1k slots/s):",
          {hex(k): round(v, 2) for k, v in tp.items()}, flush=True)
    if args.trace:
        l1_tracer.write(args.trace)
        print(f"trace written to {args.trace}", flush=True)
    return 0 if res.ok_count == n else 1


if __name__ == "__main__":
    sys.exit(main())
