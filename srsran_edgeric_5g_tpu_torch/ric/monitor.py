"""muApp3 — live throughput monitor on the metrics SUB.

Port of ``srsran_edgeric_5g_tpu/ric/monitor.py`` (a copy).

Counterpart of edgeric-v2/muApp3/muApp3_monitor.py: subscribe the per-TTI
``Metrics`` stream, track per-RNTI Tx rates in bounded deques, and plot the
moving average of the total (muApp3_monitor.py:36-70 data_fetching_thread +
FuncAnimation).  The reference renders a matplotlib window and titles it
with the redis-selected algorithm; this environment is headless, so the
renderer is a terminal line / JSON snapshot with the same quantities, and
the algorithm label comes from the same ``AlgorithmSwitch`` the muApp1 loop
reads (ric.switchboard — the redis 'scheduling_algorithm' key equivalent).
"""

from __future__ import annotations

import json
from collections import deque

import numpy as np

from .messenger import RicMessenger


class ThroughputMonitor:
    """Per-RNTI Tx tracking + total moving average (the muApp3 state)."""

    def __init__(self, window: int = 500, per_ue_window: int = 1500):
        self.tx_values: dict[int, deque] = {}
        self.total_tx_sum: deque = deque(maxlen=window)
        self.total_moving_average: list[float] = []
        self.ttis = 0

    def update(self, ue_data: dict[int, dict]) -> None:
        """One metrics message: per-UE Tx (kbit, muApp3's tx*8/1000) in,
        moving average of the total appended."""
        tot = 0.0
        for rnti, d in ue_data.items():
            tx = d["tx_bytes"] * 8.0 / 1000.0
            tot += tx
            self.tx_values.setdefault(
                rnti, deque(maxlen=1500)).append(tx)
        self.total_tx_sum.append(tot)
        self.total_moving_average.append(float(np.mean(self.total_tx_sum)))
        self.ttis += 1

    def snapshot(self, algorithm: str | None = None) -> dict:
        """JSON-able dashboard state (per-UE averages + total MA)."""
        return {
            "ttis": self.ttis,
            "algorithm": algorithm or "default",
            "total_ma_kbit": (self.total_moving_average[-1]
                              if self.total_moving_average else 0.0),
            "per_ue_kbit": {hex(r): float(np.mean(v)) if v else 0.0
                            for r, v in self.tx_values.items()},
        }

    def render(self, algorithm: str | None = None) -> str:
        s = self.snapshot(algorithm)
        ues = " ".join(f"{r}:{v:7.1f}" for r, v in s["per_ue_kbit"].items())
        return (f"[muApp3] tti {s['ttis']:>7d}  sched={s['algorithm']:<12s}"
                f"  total MA {s['total_ma_kbit']:8.1f} kbit/TTI  | {ues}")


def run(messenger: RicMessenger | None = None, ttis: int | None = None,
        every: int = 100, json_out: bool = False, switch=None) -> ThroughputMonitor:
    """The muApp3 main loop: consume metrics, print the dashboard line
    every ``every`` TTIs (or JSON when ``json_out``) until ``ttis`` messages
    (None = forever)."""
    msgr = messenger or RicMessenger()
    mon = ThroughputMonitor()
    try:
        while ttis is None or mon.ttis < ttis:
            _, ue_data = msgr.get_metrics(blocking=True, timeout_ms=1000)
            if not ue_data:
                continue
            mon.update(ue_data)
            if mon.ttis % every == 0:
                algo = switch.get() if switch is not None else None
                line = (json.dumps(mon.snapshot(algo)) if json_out
                        else mon.render(algo))
                print(line, flush=True)
    except KeyboardInterrupt:
        pass
    return mon


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="muApp3 throughput monitor")
    ap.add_argument("--ttis", type=int, default=None)
    ap.add_argument("--every", type=int, default=100)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    from .switchboard import AlgorithmSwitch
    run(ttis=args.ttis, every=args.every, json_out=args.json,
        switch=AlgorithmSwitch())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
