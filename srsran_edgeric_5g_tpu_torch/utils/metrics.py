"""Per-slot metrics collection and sinks.

Copy of ``srsran_edgeric_5g_tpu/utils/metrics.py`` (plain Python; the port
keeps its own so that it never imports the JAX package).  Counterpart of the
reference's metrics_hub + stdout/JSON plotters and the UDP JSON metrics
channel (srsRAN-5G-ER/apps/services/metrics_plotter_stdout.cpp,
metrics_hub.cpp, gnb.cpp:389-400) plus the EdgeRIC per-TTI metric taps
(lib/edgeric/edgeric.cpp:61-125): a slot-indexed record of per-UE PHY
results that can be printed, dumped as JSON lines, or sent over UDP as
JSON — the same external surface the RIC consumes.
"""

from __future__ import annotations

import dataclasses
import json
import socket
from collections import deque
from typing import Iterable


@dataclasses.dataclass
class UeSlotMetrics:
    rnti: int
    tb_crc_ok: bool
    tbs: int
    sinr_db: float = float("nan")
    noise_var: float = float("nan")
    cfo_hz: float = float("nan")
    dl_bytes: int = 0
    ul_bytes: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SlotMetrics:
    slot: int
    ues: list[UeSlotMetrics]
    # Cell-level TX amplitude-controller metrics (ops.amplitude — the
    # reference lower PHY logs these per transmit: avg/peak power, PAPR,
    # clipped-sample ratio; amplitude_controller_clipping_impl.cpp).
    tx_avg_power: float = float("nan")
    tx_papr_db: float = float("nan")
    tx_clipped_ratio: float = float("nan")

    def to_dict(self) -> dict:
        d = {"slot": self.slot, "ues": [u.to_dict() for u in self.ues]}
        if self.tx_avg_power == self.tx_avg_power:  # not NaN
            d.update(tx_avg_power=self.tx_avg_power, tx_papr_db=self.tx_papr_db,
                     tx_clipped_ratio=self.tx_clipped_ratio)
        return d


class MetricsHub:
    """Bounded in-memory store + fan-out to sinks."""

    def __init__(self, history: int = 1024):
        self._history: deque[SlotMetrics] = deque(maxlen=history)
        self._sinks: list = []

    def add_sink(self, sink) -> None:
        self._sinks.append(sink)

    def report(self, m: SlotMetrics) -> None:
        self._history.append(m)
        for s in self._sinks:
            s.handle(m)

    @property
    def history(self) -> Iterable[SlotMetrics]:
        return iter(self._history)

    def throughput_mbps(self, srate_slots_per_s: float = 1000.0) -> dict[int, float]:
        """Aggregate DL throughput per RNTI over the stored history."""
        total: dict[int, int] = {}
        n = 0
        for m in self._history:
            n += 1
            for u in m.ues:
                total[u.rnti] = total.get(u.rnti, 0) + (u.dl_bytes if u.tb_crc_ok else 0)
        if n == 0:
            return {}
        return {r: 8 * b / (n / srate_slots_per_s) / 1e6 for r, b in total.items()}


class StdoutSink:
    """Reference metrics_plotter_stdout-style one-line-per-slot output."""

    def __init__(self, every: int = 100):
        self.every = every

    def handle(self, m: SlotMetrics) -> None:
        if m.slot % self.every:
            return
        parts = [f"slot={m.slot}"]
        for u in m.ues:
            parts.append(f"rnti=0x{u.rnti:04x} crc={'OK' if u.tb_crc_ok else 'KO'} "
                         f"sinr={u.sinr_db:.1f}dB")
        print(" | ".join(parts))


class JsonLinesSink:
    def __init__(self, path: str):
        self._f = open(path, "a")

    def handle(self, m: SlotMetrics) -> None:
        self._f.write(json.dumps(m.to_dict()) + "\n")
        self._f.flush()


class UdpJsonSink:
    """The reference's UDP JSON metrics channel (gnb.cpp:389-396)."""

    def __init__(self, addr: str, port: int):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._dest = (addr, port)

    def handle(self, m: SlotMetrics) -> None:
        self._sock.sendto(json.dumps(m.to_dict()).encode(), self._dest)
