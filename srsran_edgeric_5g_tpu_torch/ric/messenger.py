"""RIC-side ZMQ messenger — wire-identical to edgeric-v2/edgeric_messenger.py.

Port of ``srsran_edgeric_5g_tpu/ric/messenger.py``.  SUB the per-TTI
``Metrics`` protobuf from the RAN (CONFLATE=1 keeps only the newest,
edgeric_messenger.py:17-20), PUB ``SchedulingWeights`` / ``mcs_control`` as
flattened [rnti, value] pairs echoing the ``ran_index`` the decision was
computed from (the staleness-accounting contract, edgeric.cpp:265).

This talks the same sockets as the reference RAN, so it interoperates with
either side: an ``EdgericAgent`` of either package or the reference gNB.
pyzmq and protobuf are imported when a messenger is built, not before.
"""

from __future__ import annotations

from ..runtime.edgeric import MCS_EP, METRICS_EP, WEIGHTS_EP


class RicMessenger:
    """The EdgericMessenger counterpart that lives in the muApp process."""

    def __init__(self, metrics_ep: str = METRICS_EP,
                 weights_ep: str = WEIGHTS_EP,
                 mcs_ep: str = MCS_EP, context=None):
        import zmq

        from ..runtime.protobufs import edgeric_pb2
        self._zmq = zmq
        self._pb = edgeric_pb2
        self._ctx = context or zmq.Context.instance()
        self._sub = self._ctx.socket(zmq.SUB)
        self._sub.setsockopt(zmq.CONFLATE, 1)
        self._sub.setsockopt(zmq.SUBSCRIBE, b"")
        self._sub.connect(metrics_ep)
        self._pub_w = self._ctx.socket(zmq.PUB)
        self._pub_w.bind(weights_ep)
        self._pub_m = None
        self._mcs_ep = mcs_ep

    def get_metrics(self, blocking: bool = True, timeout_ms: int = 1000):
        """Latest RAN metrics -> (ran_tti, {rnti: {field: value}}) or
        (None, {}) when non-blocking and nothing arrived."""
        zmq = self._zmq
        if blocking:
            if not self._sub.poll(timeout_ms):
                return None, {}
            raw = self._sub.recv()
        else:
            try:
                raw = self._sub.recv(zmq.DONTWAIT)
            except zmq.Again:
                return None, {}
        m = self._pb.Metrics.FromString(raw)
        ue_data = {u.rnti: {"cqi": u.cqi, "snr": u.snr,
                            "tx_bytes": u.tx_bytes, "rx_bytes": u.rx_bytes,
                            "dl_buffer": u.dl_buffer, "ul_buffer": u.ul_buffer,
                            "dl_tbs": u.dl_tbs}
                   for u in m.ue_metrics}
        return m.tti_cnt, ue_data

    def send_scheduling_weight(self, ran_tti: int,
                               weights: dict[int, float]) -> None:
        """PUB {rnti: weight} as the flattened pair layout."""
        flat: list[float] = []
        for rnti, w in weights.items():
            flat += [float(rnti), float(w)]
        msg = self._pb.SchedulingWeights(ran_index=int(ran_tti or 0),
                                         weights=flat)
        self._pub_w.send(msg.SerializeToString())

    def send_mcs(self, ran_tti: int, mcs: dict[int, int]) -> None:
        if self._pub_m is None:
            self._pub_m = self._ctx.socket(self._zmq.PUB)
            self._pub_m.bind(self._mcs_ep)
        flat: list[float] = []
        for rnti, v in mcs.items():
            flat += [float(rnti), float(v)]
        msg = self._pb.McsControl(ran_index=int(ran_tti or 0), mcs=flat)
        self._pub_m.send(msg.SerializeToString())

    def close(self) -> None:
        for s in (self._sub, self._pub_w, self._pub_m):
            if s is not None:
                s.close(linger=0)
