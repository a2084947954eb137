"""Parity of the port's EdgeRIC layers with the JAX package's: the RT-E2 wire
(``runtime/edgeric.py`` and ``ric/messenger.py`` over ZMQ and protobuf),
the muApp policies and their scheduler, the algorithm switch, the monitor,
and the serving half of the RL and NeurWIN networks.

The wire runs over ``ipc://`` endpoints under ``tmp_path`` (never the
fixed ``ipc:///tmp`` defaults, which the JAX app's tests bind): each
package's agent talks to the other package's messenger, and the bytes each
agent publishes are compared.  Policies, the monitor and the switch are
plain Python: exact.  Networks: within 1e-6.
"""

import dataclasses
import math
import time
import uuid

import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.ric import messenger as jmsg, monitor as jmon, muapp as jmu
from srsran_edgeric_5g_tpu.ric import neurwin as jnw, rl as jrl, switchboard as jsw
from srsran_edgeric_5g_tpu.runtime import edgeric as jedg
from srsran_edgeric_5g_tpu.utils import metrics as jmet
from srsran_edgeric_5g_tpu_torch import convert, ric as tric
from srsran_edgeric_5g_tpu_torch.ric import messenger as tmsg, monitor as tmon, muapp as tmu
from srsran_edgeric_5g_tpu_torch.ric import neurwin as tnw, rl as trl, switchboard as tsw
from srsran_edgeric_5g_tpu_torch.runtime import edgeric as tedg
from srsran_edgeric_5g_tpu_torch.utils import metrics as tmet

torch.set_num_threads(2)

RNTIS = [0x4601, 0x4602, 0x4603]


def _reports(mod, tti):
    """Reports whose float fields are float32-exact (the wire's type)."""
    return [mod.UeReport(rnti=r, cqi=(tti + 3 * i) % 16, snr=18.5 - i,
                         tx_bytes=1024.0 * (tti + i), rx_bytes=256.0 * i,
                         dl_buffer=3000 * i + tti, ul_buffer=700 * i,
                         dl_tbs=8448.0 + i)
            for i, r in enumerate(RNTIS)]


def _ue_data(reports):
    return {r.rnti: {"cqi": r.cqi, "snr": r.snr, "tx_bytes": r.tx_bytes,
                     "rx_bytes": r.rx_bytes, "dl_buffer": r.dl_buffer,
                     "ul_buffer": r.ul_buffer, "dl_tbs": r.dl_tbs}
            for r in reports}


# -------------------------------------------------------------- wire


@pytest.mark.parametrize("ric_side", ["port", "jax"])
def test_wire_agents_and_messenger(tmp_path, ric_side):
    """Both packages' agents share the policy channels of one messenger
    (``ric_side``'s), which listens to the other package's agent: the
    metrics arrive as sent, both agents publish the same bytes, and both
    read the same normalised weights, MCS overrides, ages and fail-open."""
    zmq = pytest.importorskip("zmq")
    tag = uuid.uuid4().hex[:8]

    def ep(name):
        return f"ipc://{tmp_path}/{name}-{tag}"

    ctx = zmq.Context()
    m_ep = {"port": ep("metrics-port"), "jax": ep("metrics-jax")}
    agents = {"port": tedg.EdgericAgent(m_ep["port"], ep("w"), ep("mcs"), context=ctx),
              "jax": jedg.EdgericAgent(m_ep["jax"], ep("w"), ep("mcs"), context=ctx)}
    listened = "jax" if ric_side == "port" else "port"
    msgr = (tmsg if ric_side == "port" else jmsg).RicMessenger(
        m_ep[listened], ep("w"), ep("mcs"), context=ctx)
    raw = {}
    for k, e in m_ep.items():
        raw[k] = ctx.socket(zmq.SUB)
        raw[k].setsockopt(zmq.SUBSCRIBE, b"")
        raw[k].connect(e)
    mods = {"port": tedg, "jax": jedg}
    try:
        time.sleep(0.2)
        ran_tti, ue_data = None, {}
        for _ in range(100):                      # until the SUBs have joined
            tti = agents["port"].tti
            for k, a in agents.items():
                a.send_metrics(_reports(mods[k], tti))
            ran_tti, ue_data = msgr.get_metrics(blocking=True, timeout_ms=50)
            if ue_data:
                break
        assert ue_data == _ue_data(_reports(tedg, ran_tti))
        assert agents["port"].tti == agents["jax"].tti == ran_tti + 1
        # One more TTI: each agent's bytes, read raw.
        for sock in raw.values():
            while sock.poll(0):
                sock.recv()
        for k, a in agents.items():
            a.send_metrics(_reports(mods[k], a.tti))
        sent = {k: s.recv() if s.poll(2000) else None for k, s in raw.items()}
        assert sent["port"] is not None and sent["port"] == sent["jax"]
        msgr.get_metrics(blocking=True, timeout_ms=2000)

        weights = {RNTIS[0]: 3.0, RNTIS[1]: 1.0, 0x9999: 5.0}
        mcs = {RNTIS[1]: 20, 0x9999: 3}
        got_w, got_m, ages = {}, {}, {}
        for _ in range(100):
            msgr.send_scheduling_weight(ran_tti, weights)
            msgr.send_mcs(ran_tti, mcs)
            time.sleep(0.02)
            for k, a in agents.items():
                if k not in got_w:
                    w = a.get_weights(RNTIS)
                    if w is not None:
                        got_w[k], ages[k] = w, a.weights_age
                if k not in got_m:
                    m = a.get_mcs(RNTIS)
                    if m is not None:
                        got_m[k] = (m, a.mcs_age)
            if len(got_w) == len(got_m) == 2:
                break
        assert got_w["port"] == got_w["jax"] == {RNTIS[0]: 0.75, RNTIS[1]: 0.25}
        assert ages["port"] == ages["jax"] == 2
        assert got_m["port"] == got_m["jax"] == ({RNTIS[1]: 20}, 2)
        time.sleep(0.1)
        for a in agents.values():                 # the repeats sent above
            a.get_weights(RNTIS)
            a.get_mcs(RNTIS)
        for a in agents.values():                 # fail-open: nothing new
            assert a.get_weights(RNTIS) is None and a.weights_age is None
            assert a.get_mcs(RNTIS) is None and a.mcs_age is None
        # Weights naming no RNTI of the cell are no policy either.
        for _ in range(100):
            msgr.send_scheduling_weight(ran_tti, {0x9999: 1.0})
            time.sleep(0.02)
            outs = [a.get_weights(RNTIS) for a in agents.values()]
            if agents["port"].weights_age is None and agents["jax"].weights_age is None:
                break
        assert outs == [None, None]
    finally:
        for a in agents.values():
            a.close()
        msgr.close()
        for s in raw.values():
            s.close(linger=0)
        ctx.term()


def test_metrics_sink_and_cqi_map():
    """EdgericMetricsSink turns a slot's metrics into the same reports and
    polls the same channels; cqi_from_sinr_db agrees everywhere, NaN too."""
    class Agent:
        def __init__(self):
            self.sent, self.polled = [], []

        def send_metrics(self, reports):
            self.sent.append([dataclasses.asdict(r) for r in reports])

        def get_weights(self, rntis):
            self.polled.append(list(rntis))
            return {rntis[0]: 1.0}

        def get_mcs(self, rntis):
            return None

    out = []
    for edg, met in ((jedg, jmet), (tedg, tmet)):
        agent = Agent()
        sink = edg.EdgericMetricsSink(agent)
        for slot in range(3):
            sink.handle(met.SlotMetrics(slot=slot, ues=[
                met.UeSlotMetrics(rnti=r, tb_crc_ok=True, tbs=6272,
                                  sinr_db=float("nan") if i == 2 else 11.0 + slot,
                                  dl_bytes=784, ul_bytes=784 * (i % 2))
                for i, r in enumerate(RNTIS)]))
        out.append((agent.sent, agent.polled, sink.weights, sink.mcs))
    assert out[1] == out[0]
    for s in list(np.linspace(-20.0, 40.0, 241)) + [float("nan")]:
        assert tedg.cqi_from_sinr_db(float(s)) == jedg.cqi_from_sinr_db(float(s))
    for s in (math.inf, -math.inf):
        for edg in (jedg, tedg):
            with pytest.raises(OverflowError):
                edg.cqi_from_sinr_db(s)


# ---------------------------------------------------------- policies


def _ue_stream(seed, n=60):
    rng = np.random.default_rng(seed)
    for t in range(n):
        k = 2 + t % 3
        yield {0x4601 + u: {"cqi": int(rng.integers(0 if t % 7 == 0 else 1, 16)),
                            "ul_buffer": int(rng.integers(0, 5000)),
                            "dl_buffer": int(rng.integers(0, 9000)),
                            "tx_bytes": float(rng.integers(0, 10 ** 6)),
                            "snr": float(rng.normal(15, 5)),
                            "rx_bytes": 0.0, "dl_tbs": 0.0}
               for u in range(k)}


@pytest.mark.parametrize("algo", jmu.ALGORITHMS)
def test_muapp_policies(algo):
    assert tmu.ALGORITHMS == jmu.ALGORITHMS
    state = {"jax": ({}, 0), "port": ({}, 0)}
    for ue_data in _ue_stream(hash(algo) % 1000):
        outs = {}
        for k, mod in (("jax", jmu), ("port", tmu)):
            avg, cnt = state[k]
            if algo == "fixed":
                w = mod.fixed_weights(ue_data)
            elif algo == "max_cqi":
                w = mod.max_cqi_weights(ue_data)
            elif algo == "max_weight":
                w = mod.max_weight_weights(ue_data)
            elif algo == "prop_fair":
                w, avg = mod.prop_fair_weights(ue_data, avg)
            else:
                w, cnt = mod.round_robin_weights(ue_data, cnt)
            state[k] = (avg, cnt)
            outs[k] = w
        assert outs["port"] == outs["jax"]
        assert state["port"] == state["jax"]


class _FakeMessenger:
    """RicMessenger's two calls over a prepared metrics stream."""

    def __init__(self, stream):
        self.stream, self.sent = list(stream), []

    def get_metrics(self, blocking=True, timeout_ms=1000):
        return (len(self.sent), self.stream.pop(0)) if self.stream else (None, {})

    def send_scheduling_weight(self, ran_tti, weights):
        self.sent.append((ran_tti, dict(weights)))


def test_muapp_scheduler_with_live_switch(tmp_path):
    """MuAppScheduler.step under a live AlgorithmSwitch key, every
    algorithm in turn (the NeurWIN one with the JAX package's index network
    carried over by convert): both packages send the same weights."""
    torch.manual_seed(0)
    jnet = jnw.IndexNet()
    tnet = convert.index_net_from_reference(jnet.state_dict())
    sent = {}
    for k, mu, sw, nw in (("jax", jmu, jsw, jnw), ("port", tmu, tsw, tnw)):
        switch = sw.AlgorithmSwitch(str(tmp_path / f"algo-{k}"), default="fixed")
        net = jnet if k == "jax" else tnet
        msgr = _FakeMessenger(_ue_stream(5, 48))
        sched = mu.MuAppScheduler(msgr, switch=switch,
                                  whittle_policy=nw.WhittleIndexPolicy(net))
        for step in range(50):
            if step % 8 == 0:
                switch.set((*mu.ALGORITHMS, "whittle")[step // 8 % 6])
                time.sleep(0.002)               # a new mtime for the key
            assert sched.step(blocking=False) == (step < 48)
        sent[k] = (msgr.sent, sched.total_brate, sched.algorithm)
    assert sent["port"][1:] == sent["jax"][1:]
    for (tj, wj), (tt, wt) in zip(sent["jax"][0], sent["port"][0]):
        assert tt == tj and wt.keys() == wj.keys()
        np.testing.assert_allclose(list(wt.values()), list(wj.values()), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        tmu.MuAppScheduler(_FakeMessenger(_ue_stream(1, 1)), algorithm="nope").step()


def test_algorithm_switch(tmp_path):
    for sw in (jsw, tsw):
        s = sw.AlgorithmSwitch(str(tmp_path / f"key-{sw.__name__}"))
        assert s.get() == "max_cqi"
        s.set("  prop_fair\n")
        assert s.get() == "prop_fair"
        s.clear()
        assert s.get() == "max_cqi"
    assert tsw.KEY == jsw.KEY
    try:
        import redis  # noqa: F401
    except ModuleNotFoundError:
        for sw in (jsw, tsw):
            with pytest.raises(ModuleNotFoundError):
                sw.RedisSwitch()


def test_throughput_monitor(capsys):
    out = []
    for mon_mod in (jmon, tmon):
        msgr = _FakeMessenger(_ue_stream(9, 30))
        mon = mon_mod.run(messenger=msgr, ttis=30, every=10, json_out=False)
        out.append((mon.snapshot("x"), mon.render(), capsys.readouterr().out))
    assert out[1] == out[0]
    assert out[0][2].count("[muApp3]") == 3


# ----------------------------------------------------------- networks


@pytest.mark.parametrize("hidden,log_std,scaled", [((64, 64), 0.0, True),
                                                   ((32,), -0.7, False)])
def test_policy_carried_over(tmp_path, hidden, log_std, scaled):
    """The reference's Policy through convert.policy_from_reference: equal
    forward outputs and actions, deterministic or sampled (the same global
    draws, or a generator of its own); served by TorchWeightPolicy from a
    whole-object checkpoint of the port's class with the reference's
    weights."""
    torch.manual_seed(3)
    jp = jrl.build_policy(9, 3, hidden, log_std)
    scale = np.array([1e-5, 1 / 15.0, 1e-6], np.float32) if scaled else None
    if scaled:
        jp.obs_scale = scale
    tp = convert.policy_from_reference(jp.state_dict(), 9, 3, hidden, log_std,
                                       obs_scale=scale)
    assert type(tp) is trl.Policy and not tp.training
    x = torch.randn(17, 9) * 3
    with torch.no_grad():
        for a, b in zip(jp(x), tp(x)):
            torch.testing.assert_close(b, a, rtol=0, atol=1e-6)
        torch.testing.assert_close(tp.select_action(x, deterministic=True),
                                   jp.select_action(x, deterministic=True),
                                   rtol=0, atol=1e-6)
        torch.manual_seed(11)
        aj = jp.select_action(x)
        torch.manual_seed(11)
        torch.testing.assert_close(tp.select_action(x), aj, rtol=0, atol=1e-6)
        g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
        torch.testing.assert_close(tp.select_action(x, generator=g1),
                                   tp.select_action(x, generator=g2), rtol=0, atol=0)
        torch.testing.assert_close(tp.get_log_prob(x, aj), jp.get_log_prob(x, aj),
                                   rtol=0, atol=1e-5)
    pj, pt = tmp_path / "jax.pt", tmp_path / "port.pt"
    torch.save(jp, pj)
    torch.save(tp, pt)
    ue_data = next(iter(_ue_stream(2)))
    ue_data = {r: d for r, d in list(ue_data.items())[:1]} | {
        0x4609: {"cqi": 7, "ul_buffer": 12, "dl_buffer": 0, "tx_bytes": 0.0,
                 "snr": 0.0, "rx_bytes": 0.0, "dl_tbs": 0.0},
        0x460a: {"cqi": 15, "ul_buffer": 4000, "dl_buffer": 0, "tx_bytes": 0.0,
                 "snr": 0.0, "rx_bytes": 0.0, "dl_tbs": 0.0}}
    wj, wt = jmu.TorchWeightPolicy(str(pj)), tmu.TorchWeightPolicy(str(pt))
    assert type(wt.model).__module__ == "srsran_edgeric_5g_tpu_torch.ric.rl"
    for seed in range(4):
        torch.manual_seed(seed)
        a = wj(ue_data)
        torch.manual_seed(seed)
        b = wt(ue_data)
        assert a.keys() == b.keys()
        np.testing.assert_allclose(list(b.values()), list(a.values()), rtol=0, atol=1e-6)


def test_index_net_and_neurwin_checkpoints(tmp_path):
    """IndexNet through convert.index_net_from_reference; a checkpoint the
    JAX package's save_checkpoint wrote loads in the port (and back) with
    the same indices and weights."""
    torch.manual_seed(4)
    jnet = jnw.IndexNet()
    tnet = convert.index_net_from_reference(jnet.state_dict())
    x = torch.rand(64, 2)
    with torch.no_grad():
        torch.testing.assert_close(tnet(x), jnet(x), rtol=0, atol=1e-6)
        torch.testing.assert_close(tnet(x[0].numpy()), jnet(x[0].numpy()),
                                   rtol=0, atol=1e-6)
    jnw.save_checkpoint(jnet, str(tmp_path / "j.pt"))
    tnw.save_checkpoint(tnet, str(tmp_path / "t.pt"))
    pol = {"jax": jnw.WhittleIndexPolicy(str(tmp_path / "t.pt")),
           "port": tnw.WhittleIndexPolicy(str(tmp_path / "j.pt"))}
    assert type(pol["port"].net) is tnw.IndexNet
    np.testing.assert_array_equal(tnw.OBS_SCALE, jnw.OBS_SCALE)
    for ue_data in _ue_stream(6, 20):
        ij, it = pol["jax"].indices(ue_data), pol["port"].indices(ue_data)
        assert ij.keys() == it.keys()
        np.testing.assert_allclose(list(it.values()), list(ij.values()), rtol=0, atol=1e-6)
        wj, wt = pol["jax"](ue_data), pol["port"](ue_data)
        np.testing.assert_allclose(list(wt.values()), list(wj.values()), rtol=0, atol=1e-6)


def test_ric_exports():
    from srsran_edgeric_5g_tpu import ric as jric
    names = [n for n in vars(jric) if not n.startswith("_")
             and not isinstance(getattr(jric, n), type(jric))]
    assert names and all(hasattr(tric, n) for n in names)
    assert tric.RicMessenger is tmsg.RicMessenger
