"""Parity of the port's host layers with the JAX reference's: the PHY
configuration (YAML load, derivation, validation messages), the metrics hub
and its sinks, the Chrome trace tracer, the radio events (slot clock, real-
time deadline, fail-open), the native IQ bridge binding, and the port's
loopback app: its slot loop on an in-process radio, and the app itself as a
subprocess over the native ZMQ bridge, in a process that never loads JAX.

These layers are plain Python over the same inputs: every comparison is
exact.
"""

import dataclasses
import errno
import json
import os
import pathlib
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu import config as jcfg
from srsran_edgeric_5g_tpu.runtime import events as jev
from srsran_edgeric_5g_tpu.utils import metrics as jmet, tracing as jtr
from srsran_edgeric_5g_tpu_torch import config as tcfg, loopback_app
from srsran_edgeric_5g_tpu_torch.models import cell_processor as tcp
from srsran_edgeric_5g_tpu_torch.runtime import events as tev, iqbridge as tiq
from srsran_edgeric_5g_tpu_torch.utils import metrics as tmet, tracing as ttr

# Six test workers share the host with the JAX tests: two intra-op threads.
torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
# tests/test_app_e2e.py's cell: 10 MHz, 2 UEs, 16QAM r0.4.
APP_YAML = """
cell:
  bandwidth_mhz: 10
  pci: 7
  nof_ue: 2
  modulation: qam16
  target_rate: 0.4
"""


def test_config_load_and_derivation(tmp_path):
    path = tmp_path / "cell.yml"
    path.write_text(APP_YAML + "  delay_spread_us: 1.5\n# comment\n")
    assert tcfg.load_yaml(path) == jcfg.load_yaml(path)
    cj, ct = jcfg.load(path), tcfg.load(path)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert (ct.nof_prb, ct.nfft, ct.srate) == (cj.nof_prb, cj.nfft, cj.srate)
    assert dataclasses.asdict(ct.timing) == dataclasses.asdict(cj.timing)
    cell_j, cell_t = cj.cell_config(), ct.cell_config()
    assert type(cell_t).__module__.startswith("srsran_edgeric_5g_tpu_torch.")
    assert dataclasses.asdict(cell_t) == dataclasses.asdict(cell_j)
    assert cell_t.derived_tbs() == cell_j.derived_tbs()
    for bw in tcfg.BW_TABLE_15KHZ:
        assert (dataclasses.asdict(tcfg.PhyConfig(bandwidth_mhz=bw).cell_config())
                == dataclasses.asdict(jcfg.PhyConfig(bandwidth_mhz=bw).cell_config()))
    assert tcfg.BW_TABLE_15KHZ == jcfg.BW_TABLE_15KHZ


@pytest.mark.parametrize("kw", [
    dict(scs_khz=30), dict(bandwidth_mhz=7), dict(pci=1008), dict(pci=-1),
    dict(nof_ue=0), dict(nof_ue=20), dict(delay_spread_us=11.0),
    dict(delay_spread_us=-0.5)])
def test_config_validation_messages(kw):
    """Each validation error carries the reference's message, word for word."""
    with pytest.raises(ValueError) as ej:
        jcfg.PhyConfig(**kw)
    with pytest.raises(ValueError) as et:
        tcfg.PhyConfig(**kw)
    assert str(et.value) == str(ej.value)


def test_config_unknown_keys():
    with pytest.raises(ValueError) as ej:
        jcfg.from_dict({"bandwidth_mhz": 10, "bogus": 1})
    with pytest.raises(ValueError) as et:
        tcfg.from_dict({"bandwidth_mhz": 10, "bogus": 1})
    assert str(et.value) == str(ej.value)
    # Under a "cell" section unknown keys are ignored, as in the reference.
    assert (dataclasses.asdict(tcfg.from_dict({"cell": {"nof_ue": 4, "x": 1}}))
            == dataclasses.asdict(jcfg.from_dict({"cell": {"nof_ue": 4, "x": 1}})))


def _slot_metrics(mod, slot, ok):
    ues = [mod.UeSlotMetrics(rnti=0x4601 + u, tb_crc_ok=bool(ok[u]), tbs=1000,
                             sinr_db=20.0 + u, noise_var=0.01, cfo_hz=1.5,
                             ul_bytes=125 if ok[u] else 0, dl_bytes=125)
           for u in range(len(ok))]
    if slot % 2:
        return mod.SlotMetrics(slot=slot, ues=ues, tx_avg_power=0.5,
                               tx_papr_db=9.0, tx_clipped_ratio=0.0)
    return mod.SlotMetrics(slot=slot, ues=ues)


def test_metrics_hub_and_sinks(tmp_path, capsys):
    """The same reports give the same history, throughput, stdout lines,
    JSON lines and UDP datagrams."""
    out = {}
    for name, mod in (("jax", jmet), ("torch", tmet)):
        hub = mod.MetricsHub(history=4)
        hub.add_sink(mod.StdoutSink(every=2))
        hub.add_sink(mod.JsonLinesSink(str(tmp_path / f"{name}.jsonl")))
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(5.0)
        hub.add_sink(mod.UdpJsonSink("127.0.0.1", rx.getsockname()[1]))
        for slot in range(6):
            hub.report(_slot_metrics(mod, slot, [slot % 3 != 0, True]))
        grams = [rx.recv(65536).decode() for _ in range(6)]
        rx.close()
        out[name] = dict(
            history=[m.to_dict() for m in hub.history],
            tp=hub.throughput_mbps(), stdout=capsys.readouterr().out,
            jsonl=(tmp_path / f"{name}.jsonl").read_text(), udp=grams)
    assert out["torch"] == out["jax"]
    assert len(out["torch"]["history"]) == 4
    assert out["torch"]["stdout"].count("slot=") == 3


def test_tracer_spans_and_instants(tmp_path):
    """The same spans and instants give the same event records (names,
    phases, args), and a disabled tracer records nothing."""
    docs = {}
    for name, mod in (("jax", jtr), ("torch", ttr)):
        tr = mod.EventTracer()
        with tr.span("off"):
            pass
        tr.instant("off")
        tr.enable()
        with tr.span("dl_slot", slot=0):
            pass
        tr.instant("prach_detect", preamble=9, delay=3)
        with tr.span("ul_slot", slot=0):
            pass
        tr.write(str(tmp_path / f"{name}.json"))
        doc = json.loads((tmp_path / f"{name}.json").read_text())
        docs[name] = [{k: e[k] for k in ("name", "ph", "args")}
                      for e in doc["traceEvents"]]
        assert all(e["ts"] >= 0 for e in doc["traceEvents"])
        tr.clear()
        assert tr.enabled
    assert docs["torch"] == docs["jax"]
    assert [e["name"] for e in docs["torch"]] == ["dl_slot", "prach_detect", "ul_slot"]
    assert isinstance(ttr.l1_tracer, ttr.EventTracer)


def test_slot_clock_deadline_fail_open():
    """One sequence of clock advances, deadline checks and failing handlers
    gives the same results, counters and log lines."""
    res = {}
    for name, mod in (("jax", jev), ("torch", tev)):
        logs, now = [], [0.0]
        n = mod.RadioEventNotifier(log=logs.append)
        clk = mod.SlotClock(n)
        dl = mod.SlotDeadline(1e-3, run_ahead=4, notifier=n, clock=lambda: now[0])
        got = [clk.advance(s) for s in (10, 11, 14, 12, 15)]
        tok = dl.start()
        now[0] += 3e-3
        got.append(dl.finish(0, tok))
        tok = dl.start()
        now[0] += 5e-3
        got.append(dl.finish(1, tok))

        def boom():
            raise ValueError("phy error")

        got.append(mod.fail_open(n, 7, boom, fallback="default"))
        got.append(mod.fail_open(n, 8, lambda x: x + 1, 41))
        n.on_underflow(3)
        n.on_overflow(4)
        res[name] = (got, n.events.as_dict(), n.events.total(), logs)
    assert res["torch"] == res["jax"]
    assert res["torch"][0][:5] == [[], [], [12, 13], None, []]


def test_iq_ring_and_file_roundtrip(tmp_path):
    ring = tiq.IqRing(100)
    rng = np.random.default_rng(1)
    ins, outs = [], []
    for _ in range(10):
        chunk = (rng.normal(size=37) + 1j * rng.normal(size=37)).astype(np.complex64)
        ins.append(chunk[:ring.write(chunk)])
        outs.append(ring.read(37))
    assert len(ring) == 0
    ring.close()
    np.testing.assert_array_equal(np.concatenate(outs), np.concatenate(ins))
    data = np.concatenate(ins)
    assert tiq.iq_file_write(str(tmp_path / "x.cf32"), data) == len(data)
    np.testing.assert_array_equal(tiq.iq_file_read(str(tmp_path / "x.cf32"), 4096),
                                  data)


def test_bridge_without_libzmq_raises(monkeypatch):
    """Where the system has no libzmq the port's server and client raise
    before the native code would abort the process."""
    tiq.lib()
    real = tiq.ctypes.CDLL

    def cdll(name, *a, **kw):
        if "zmq" in str(name):
            raise OSError(f"{name}: cannot open shared object file")
        return real(name, *a, **kw)

    monkeypatch.setattr(tiq.ctypes, "CDLL", cdll)
    for cls in (tiq.IqTxServer, tiq.IqRxClient):
        with pytest.raises(RuntimeError, match="libzmq not found"):
            cls("tcp://127.0.0.1:1")


def test_slot_loop_in_process_radio():
    """The app's pipelined loop with an in-process AWGN radio (the radio the
    card's smoke run uses): every TB exact; an underflow slot and a slot
    whose UL raises are counted and dropped, the cell stays up."""
    cfg = tcfg.PhyConfig()
    proc = tcp.CellProcessor(cfg.cell_config(), pci=cfg.pci, device="cpu")
    gen = torch.Generator().manual_seed(3)
    sent = {}

    def payloads(slot):
        sent[slot] = torch.randint(0, 2, (proc.cell.nof_ue, proc.tbs),
                                   generator=gen, dtype=torch.int8)
        return sent[slot]

    def radio(slot, td):
        if slot == 2:
            return None                       # underflow
        if slot == 4:
            return td[:10]                    # wrong length: the UL raises
        sigma = float(td.abs().pow(2).mean().sqrt()) * 10 ** (-25 / 20) / np.sqrt(2)
        return td + torch.complex(torch.randn(td.shape, generator=gen),
                                  torch.randn(td.shape, generator=gen)) * sigma

    notifier = tev.RadioEventNotifier()
    res = loopback_app.run_slot_loop(proc, radio, 6, payloads, run_ahead=2,
                                     notifier=notifier, log=lambda s: None)
    assert notifier.events.underflow == 1 and notifier.events.errors == 1
    assert res.ok_count == res.exact_count == 4 * proc.cell.nof_ue
    assert res.nof_tbs == 6 * proc.cell.nof_ue and len(res.latency_ms) == 4
    assert len(list(proc.metrics.history)) == 4
    assert sorted(sent) == list(range(6))


# The app takes a TCP --port, as the JAX app does.  Its port is drawn from
# below the kernel's ephemeral range (32768-60999 here), which bind(0)
# probes and outgoing connections take from, and away from the JAX app
# tests' fixed 47821-47829; a port that is taken all the same makes the
# bridge raise EADDRINUSE, and the test draws another, at most APP_TRIES
# times.
APP_PORTS = (20000, 32000)
APP_TRIES = 3
# The app's child runs 3 slots in seconds (6.2 s under the whole suite).
APP_TIMEOUT_S = 90


def _app_port() -> int:
    return random.SystemRandom().randrange(*APP_PORTS)


def test_bridge_reports_a_failed_bind():
    """A port another socket listens on: the server raises EADDRINUSE
    instead of serving nothing."""
    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen()
        with pytest.raises(OSError) as exc:
            tiq.IqTxServer(f"tcp://127.0.0.1:{held.getsockname()[1]}")
    assert exc.value.errno == errno.EADDRINUSE


def test_loopback_app_over_the_bridge(tmp_path):
    """The port's app as a subprocess on the CPU over the native ZMQ bridge
    at tests/test_app_e2e.py's cell: every TB decoded, the trace's slot
    spans written, and JAX never loaded in the child."""
    cfg = tmp_path / "cell.yml"
    cfg.write_text(APP_YAML)
    trace = tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    code = ("import runpy, sys\n"
            "sys.argv = ['loopback_app'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('srsran_edgeric_5g_tpu_torch.loopback_app',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "leaked = sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'srsran_edgeric_5g_tpu'))\n"
            "print('LEAKED', leaked)\n"
            "sys.exit(rc)\n")
    for _ in range(APP_TRIES):
        try:
            out = subprocess.run(
                [sys.executable, "-c", code, str(cfg), "--slots", "3", "--snr", "25",
                 "--port", str(_app_port()), "--trace", str(trace), "--device", "cpu"],
                capture_output=True, text=True, timeout=APP_TIMEOUT_S, env=env,
                cwd=str(REPO))
        except subprocess.TimeoutExpired as e:
            pytest.fail(f"the app ran over {APP_TIMEOUT_S} s and was killed:\n"
                        f"{e.stdout}\n{e.stderr}")
        if "could not bind" not in out.stderr:
            break
    assert out.returncode == 0, out.stdout + out.stderr
    assert "TB success 6/6" in out.stdout, out.stdout
    assert "throughput" in out.stdout
    assert "LEAKED []" in out.stdout, out.stdout
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert "dl_slot" in names and "ul_slot" in names


class _Picked(Exception):
    """Raised by a stubbed loop: its argument names the loop main picked."""


class _NoBridge:
    """Stands in for the IQ bridge's server and client (no sockets)."""

    def __init__(self, *a, **k):
        pass

    def stop(self):
        pass


class _NoAgent:
    """Stands in for an EdgeRIC agent (no sockets)."""

    tti, weights_age = 0, None

    def __init__(self, *a, **k):
        pass

    def close(self):
        pass


def _picker(loop):
    def pick(*a, **k):
        raise _Picked(loop)
    return pick


@pytest.mark.parametrize("argv,loop", [
    (["--sched", "pf"], "scheduled"), (["--edgeric"], "default"),
    (["--rach", "2"], "scheduled"), (["--bcch"], "scheduled"),
    (["--ul-traffic", "100"], "scheduled"), (["--ul-fade", "3"], "default")])
def test_loopback_app_picks_the_reference_loop(argv, loop, monkeypatch):
    """The port's main picks the loop the JAX app's main picks: the
    scheduled loop for --sched, and for --rach, --bcch and --ul-traffic
    (which turn on pf); the default loop for --edgeric and for a fade
    alone.  Each loop is stubbed to report that it was picked; the bridge
    and the agent are stubbed too, so no socket is opened."""
    import importlib.util

    import srsran_edgeric_5g_tpu.runtime as jrt
    import srsran_edgeric_5g_tpu_torch.runtime as trt
    from srsran_edgeric_5g_tpu.models import cell_processor as jcp
    from srsran_edgeric_5g_tpu.runtime import edgeric as jedg
    from srsran_edgeric_5g_tpu_torch.runtime import edgeric as tedg
    spec = importlib.util.spec_from_file_location(
        "reference_loopback_app", REPO / "tools" / "run_loopback_app.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for mod in (jrt, trt):
        monkeypatch.setattr(mod, "IqTxServer", _NoBridge)
        monkeypatch.setattr(mod, "IqRxClient", _NoBridge)
    for mod in (jedg, tedg):
        monkeypatch.setattr(mod, "EdgericAgent", _NoAgent)
    monkeypatch.setattr(ref, "run_scheduled", _picker("scheduled"))
    monkeypatch.setattr(jcp.CellProcessor, "process_dl_slot", _picker("default"))
    monkeypatch.setattr(loopback_app, "run_scheduled", _picker("scheduled"))
    monkeypatch.setattr(loopback_app, "run_slot_loop", _picker("default"))
    with pytest.raises(_Picked) as ref_pick:
        ref.main(argv + ["--slots", "2"])
    with pytest.raises(_Picked) as port_pick:
        loopback_app.main(argv + ["--slots", "2", "--device", "cpu"])
    assert str(port_pick.value) == str(ref_pick.value) == loop
