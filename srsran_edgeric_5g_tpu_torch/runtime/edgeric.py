"""EdgeRIC RT-E2 agent: the RAN side of the real-time RIC side channel.

Port of ``srsran_edgeric_5g_tpu/runtime/edgeric.py`` (the reference fork's
lib/edgeric/edgeric.cpp:31-47 sockets, :61-125 send_to_er, :252-295
get_weights_from_er, :360-400 get_mcs_from_er; Python counterpart
edgeric-v2/edgeric_messenger.py).

Per-TTI contract:
  * metrics OUT: protobuf ``Metrics`` PUB'd on ``ipc:///tmp/metrics`` with
    ZMQ_DONTWAIT — the RAN never blocks on the RIC.
  * weights IN: latest ``SchedulingWeights`` from a SUB socket; CONFLATE
    keeps only the newest message.  **Fail-open**: if nothing arrived this
    TTI the previous policy is CLEARED (edgeric.cpp:289-295) and the caller
    falls back to its default scheduler.  Weights are normalized to sum 1.
  * mcs IN: same pattern on the MCS channel.

Staleness accounting mirrors the reference: the RIC echoes the ``ran_index``
(TTI count) its decision was computed from; ``weights_age`` exposes
``tti_now - ran_index`` (er_ran_index_weights, edgeric.cpp:265).

pyzmq and protobuf are imported by ``EdgericAgent`` alone, when one is
built: the scheduler (``mac.scheduler.ue_reports``) and the scheduled loop
use ``UeReport`` and ``cqi_from_sinr_db`` and run without either.  An agent
on a host without them raises ModuleNotFoundError naming the module.
"""

from __future__ import annotations

import dataclasses
import math

METRICS_EP = "ipc:///tmp/metrics"
WEIGHTS_EP = "ipc:///tmp/control_weights_actions"
MCS_EP = "ipc:///tmp/control_mcs_actions"


@dataclasses.dataclass
class UeReport:
    rnti: int
    cqi: int = 0
    snr: float = 0.0
    tx_bytes: float = 0.0
    rx_bytes: float = 0.0
    dl_buffer: int = 0
    ul_buffer: int = 0
    dl_tbs: float = 0.0


class EdgericAgent:
    """RAN-side messenger: metrics PUB + weights/MCS SUB, fail-open."""

    def __init__(self, metrics_ep: str = METRICS_EP,
                 weights_ep: str = WEIGHTS_EP,
                 mcs_ep: str = MCS_EP, context=None):
        import zmq

        from .protobufs import edgeric_pb2
        self._zmq = zmq
        self._pb = edgeric_pb2
        self._ctx = context or zmq.Context.instance()
        self._pub = self._ctx.socket(zmq.PUB)
        self._pub.bind(metrics_ep)
        self._sub_w = self._make_sub(weights_ep)
        self._sub_m = self._make_sub(mcs_ep)
        self.tti = 0
        self.weights_age: int | None = None
        self.mcs_age: int | None = None

    def _make_sub(self, ep: str):
        s = self._ctx.socket(self._zmq.SUB)
        # CONFLATE=1 before connect: keep only the newest policy message
        # (edgeric_messenger.py:17-20 does the same on the RIC side).
        s.setsockopt(self._zmq.CONFLATE, 1)
        s.setsockopt(self._zmq.SUBSCRIBE, b"")
        s.connect(ep)
        return s

    # --- metrics out (edgeric.cpp send_to_er) ---

    def send_metrics(self, reports: list[UeReport]) -> None:
        """PUB one Metrics message for this TTI; never blocks (DONTWAIT)."""
        m = self._pb.Metrics(tti_cnt=self.tti)
        for r in reports:
            m.ue_metrics.add(rnti=r.rnti, cqi=r.cqi, snr=r.snr,
                             tx_bytes=r.tx_bytes, rx_bytes=r.rx_bytes,
                             dl_buffer=r.dl_buffer, ul_buffer=r.ul_buffer,
                             dl_tbs=r.dl_tbs)
        try:
            self._pub.send(m.SerializeToString(), self._zmq.DONTWAIT)
        except self._zmq.Again:   # no subscriber / full pipe: drop, fail-open
            pass
        self.tti += 1

    # --- policies in (edgeric.cpp get_weights_from_er / get_mcs_from_er) ---

    def get_weights(self, rntis: list[int]) -> dict[int, float] | None:
        """Latest scheduling weights as {rnti: weight} normalized to sum 1,
        or None if no (usable) policy arrived — the fail-open path: the
        caller must fall back to its default scheduler."""
        msg = self._drain(self._sub_w)
        if msg is None:
            self.weights_age = None
            return None
        w = self._pb.SchedulingWeights.FromString(msg)
        vals = list(w.weights)
        # Wire layout: flattened [rnti, weight] pairs (edgeric.cpp:262-270).
        pairs = {int(vals[i]): float(vals[i + 1])
                 for i in range(0, len(vals) - 1, 2)}
        out = {r: pairs[r] for r in rntis if r in pairs}
        if not out:
            self.weights_age = None
            return None
        total = sum(out.values())
        if total > 0:
            out = {r: v / total for r, v in out.items()}
        self.weights_age = self.tti - int(w.ran_index)
        return out

    def get_mcs(self, rntis: list[int]) -> dict[int, int] | None:
        """Latest MCS overrides as {rnti: mcs}, or None (fail-open)."""
        msg = self._drain(self._sub_m)
        if msg is None:
            self.mcs_age = None
            return None
        mc = self._pb.McsControl.FromString(msg)
        vals = list(mc.mcs)
        pairs = {int(vals[i]): int(vals[i + 1])
                 for i in range(0, len(vals) - 1, 2)}
        out = {r: pairs[r] for r in rntis if r in pairs}
        if not out:
            self.mcs_age = None
            return None
        self.mcs_age = self.tti - int(mc.ran_index)
        return out

    def _drain(self, sock) -> bytes | None:
        """Non-blocking read of the newest message (None if nothing)."""
        msg = None
        while True:
            try:
                msg = sock.recv(self._zmq.DONTWAIT)
            except self._zmq.Again:
                return msg

    def close(self) -> None:
        for s in (self._pub, self._sub_w, self._sub_m):
            s.close(linger=0)


def cqi_from_sinr_db(sinr_db: float) -> int:
    """Crude SINR->CQI map (~1.9 dB per CQI step, CQI 15 ~ 22 dB); stands in
    for the reference's CSI reporting chain when feeding the RIC."""
    if math.isnan(sinr_db):
        return 0
    return max(0, min(15, int((sinr_db + 6.7) / 1.9)))


class EdgericMetricsSink:
    """MetricsHub sink: forwards each slot's UE metrics to the RIC and polls
    the policy channels; the latest usable policies are kept on ``.weights``
    / ``.mcs`` (None = fail-open, use the default scheduler) — the same
    per-TTI cadence as the reference's scheduler hooks
    (cell_scheduler.cpp:92-96 recv, :143-144 send)."""

    def __init__(self, agent: EdgericAgent):
        self.agent = agent
        self.weights: dict[int, float] | None = None
        self.mcs: dict[int, int] | None = None

    def handle(self, m) -> None:
        rntis = [u.rnti for u in m.ues]
        self.agent.send_metrics([
            UeReport(rnti=u.rnti, cqi=cqi_from_sinr_db(u.sinr_db),
                     snr=0.0 if u.sinr_db != u.sinr_db else u.sinr_db,
                     tx_bytes=float(u.dl_bytes), rx_bytes=float(u.ul_bytes),
                     dl_tbs=float(u.tbs))
            for u in m.ues])
        self.weights = self.agent.get_weights(rntis)
        self.mcs = self.agent.get_mcs(rntis)
