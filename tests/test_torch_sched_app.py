"""The port's loopback app in its scheduled modes on the CPU, held to the JAX
app (``tools/run_loopback_app.py``).

* ``run_scheduled`` at the default PhyConfig (10 MHz, 2 UEs) with the JAX
  app's test parameters (tests/test_app_e2e.py, tests/test_rach.py), each
  meeting the JAX app's success criteria;
* one whole run against the JAX ``run_scheduled`` over the native bridge:
  the same grants, TB outcomes and bytes served from one seed;
* ``--edgeric`` in the default loop against the port's RicMessenger and
  MuAppScheduler over ``tmp_path`` endpoints;
* every port module imported, and two scheduled slots run, with pyzmq and
  protobuf blocked and JAX never loaded.

The radios draw their noise from the run's generator in the JAX app's
order, so both packages see the same draws; the grants, CRC outcomes and
counts are compared exactly.
"""

import contextlib
import dataclasses
import errno
import functools
import importlib.util
import os
import pathlib
import random
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu_torch import config as tcfg, loopback_app
from srsran_edgeric_5g_tpu_torch.mac import scheduler as tmac
from srsran_edgeric_5g_tpu_torch.runtime import edgeric as tedg
from srsran_edgeric_5g_tpu_torch.runtime.events import RadioEventNotifier

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


# The app's --port (TCP, as the JAX app's) is drawn from below the kernel's
# ephemeral range, where no bind(0) probe or outgoing connection lands, and
# away from the JAX app tests' 47821-47829; a taken port makes the bridge
# raise EADDRINUSE and the test draws another (tests/test_torch_runtime.py).
APP_PORTS = (20000, 32000)
APP_TRIES = 3
# How long the lockstep agent re-sends one TTI's metrics for the muApp's
# answer, and how often.
RIC_WAIT_S = 30.0
RIC_POLL_MS = 50
# The blocked-imports child runs two scheduled slots (14.5-25.6 s under the
# whole suite).
CHILD_TIMEOUT_S = 150


class NumpyRadio:
    """The app's radio without the bridge: ``loopback_app.awgn_np`` (the
    same draws from the run's generator as ``_radio_roundtrip``), then back
    on the samples' device."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng

    def __call__(self, slot, td, snr_db):
        return torch.as_tensor(loopback_app.awgn_np(td.cpu().numpy(), snr_db, self.rng),
                               device=td.device)


@contextlib.contextmanager
def recording(mac):
    """While open, ``mac.CellScheduler`` (either package's) records each
    DL slot's grants (as dicts) and each HARQ-ACK (rnti, pid, ok)."""
    rec = {"grants": [], "acks": []}
    run_slot, handle_dl_ack = mac.CellScheduler.run_slot, mac.CellScheduler.handle_dl_ack

    def rec_run_slot(self, *a, **k):
        grants = run_slot(self, *a, **k)
        rec["grants"].append([dataclasses.asdict(g) for g in grants])
        return grants

    def rec_ack(self, rnti, pid, ack):
        rec["acks"].append((rnti, pid, bool(ack)))
        return handle_dl_ack(self, rnti, pid, ack)

    mac.CellScheduler.run_slot, mac.CellScheduler.handle_dl_ack = rec_run_slot, rec_ack
    try:
        yield rec
    finally:
        mac.CellScheduler.run_slot, mac.CellScheduler.handle_dl_ack = run_slot, handle_dl_ack


def _run(argv, seed=0):
    """The port's run_scheduled at the default PhyConfig on the CPU."""
    args = loopback_app._parser().parse_args(argv)
    cfg = tcfg.PhyConfig()
    rng = np.random.default_rng(seed)
    logs = []
    notifier = RadioEventNotifier(log=logs.append)
    with recording(tmac) as rec:
        res = loopback_app.run_scheduled(args, cfg, cfg.cell_config(), NumpyRadio(rng),
                                         None, notifier, rng, device="cpu",
                                         log=logs.append)
    assert notifier.events.total() == 0, notifier.events.as_dict()
    return res, rec, "\n".join(logs)


@pytest.mark.parametrize("case", ["sched_pf", "ul_fade", "dl_fade", "rach", "bcch"])
def test_scheduled_modes_meet_the_app_criteria(case):
    """tests/test_app_e2e.py's and tests/test_rach.py's runs of the JAX app,
    on the port: the same criteria, through the result object."""
    argv = {"sched_pf": ["--sched", "pf", "--slots", "6"],
            "ul_fade": ["--sched", "pf", "--slots", "14", "--ul-traffic", "400",
                        "--ul-fade", "4", "--ul-fade-snr", "5"],
            "dl_fade": ["--sched", "pf", "--slots", "14", "--dl-fade", "3",
                        "--dl-fade-snr", "4"],
            "rach": ["--sched", "pf", "--slots", "30", "--rach", "2"],
            "bcch": ["--sched", "pf", "--slots", "25", "--bcch"]}[case]
    res, rec, out = _run(argv)
    assert res.code == 0, out
    assert res.dl_dropped == res.dl_in_flight == 0
    assert sum(res.bytes_served.values()) > 0
    tbs = len(rec["acks"])
    assert tbs == sum(map(len, rec["grants"]))
    assert res.tb_count == tbs and res.host_syncs >= 2 * tbs
    if case == "sched_pf":
        assert res.ok_count == res.tb_count >= 6
        assert res.layouts <= 4                  # RBG snapping bounds the layouts
    elif case == "ul_fade":
        assert "HARQ retx rv=2 decoded (soft-combined)" in out
        assert res.ul_retx_ok >= 1 and res.ul_dropped == res.ul_in_flight == 0
        assert res.sr_detected == res.sr_sent > 0 and res.bsr_rx > 0
    elif case == "dl_fade":
        assert "DL HARQ retx rv=" in out and res.dl_retx_ok >= 1
    elif case == "rach":
        for line in ("PRACH preamble 7 detected", "Msg3 ok", "contention resolved",
                     "rach: 2/2 UEs attached"):
            assert line in out
        assert res.ue_states == {"connected"} and len(res.attached) == 2
    else:
        assert "bcch: 2 SIB1 decoded, 1 paging records" in out
        assert (res.sib1_rx, res.paging_rx, res.paged_ids) == (2, 1, [7])


def _reference_app():
    spec = importlib.util.spec_from_file_location(
        "reference_loopback_app", REPO / "tools" / "run_loopback_app.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_whole_run_equals_the_reference_app(capsys, tmp_path):
    """The JAX run_scheduled over the native bridge and the port's over its
    own, --sched pf, 4 slots, each from default_rng(0): the same grants in
    every slot, the same CRC outcome per TB, the same bytes served.  The
    bridges run over ipc:// endpoints under tmp_path."""
    from srsran_edgeric_5g_tpu import config as jcfg
    from srsran_edgeric_5g_tpu.mac import scheduler as jmac
    from srsran_edgeric_5g_tpu.runtime import (IqRxClient, IqTxServer, RadioEventNotifier
                                               as JNotifier, SlotClock)
    from srsran_edgeric_5g_tpu_torch.runtime import IqRxClient as TRx, IqTxServer as TTx
    ref_app = _reference_app()
    slots = 4
    args = loopback_app._parser().parse_args(["--sched", "pf", "--slots", str(slots)])

    cfg = jcfg.PhyConfig()
    cell = cfg.cell_config()
    addr = f"ipc://{tmp_path}/iq-reference"
    tx = IqTxServer(addr, chunk=cell.timing.cp.total)
    rx = IqRxClient(addr, chunk=cell.timing.cp.total)
    try:
        notifier = JNotifier()
        with recording(jmac) as ref:
            code = ref_app.run_scheduled(args, cfg, cell, tx, rx, None, notifier,
                                         SlotClock(notifier), np.random.default_rng(0))
    finally:
        rx.stop()
        tx.stop()
    ref_out = capsys.readouterr().out
    assert code == 0, ref_out

    cfg_t = tcfg.PhyConfig()
    cell_t = cfg_t.cell_config()
    addr = f"ipc://{tmp_path}/iq-port"
    ttx, trx = TTx(addr, chunk=cell_t.timing.cp.total), TRx(addr, chunk=cell_t.timing.cp.total)
    rng = np.random.default_rng(0)

    def radio(slot, td, snr_db):
        got = loopback_app._radio_roundtrip(ttx, trx, td.cpu().numpy(), snr_db, rng,
                                            cell_t.timing.cp.total)
        return None if got is None else torch.as_tensor(got)

    try:
        with recording(tmac) as rec:
            res = loopback_app.run_scheduled(args, cfg_t, cell_t, radio, None,
                                             RadioEventNotifier(), rng, device="cpu",
                                             log=lambda s: None)
    finally:
        trx.stop()
        ttx.stop()
    assert res.code == 0
    assert rec == ref
    assert sum(map(len, ref["grants"])) >= slots
    assert f"bytes served: { {hex(r): b for r, b in res.bytes_served.items()} }" in ref_out
    assert f"TB success {res.ok_count}/{res.tb_count}, {res.layouts} compiled" in ref_out


class _LockstepAgent(tedg.EdgericAgent):
    """The port's agent with the muApp in step with the slot loop.

    The app reads the policy last in the metrics sink of its last slot,
    right after publishing that slot's metrics (EdgericMetricsSink.handle),
    and a read that finds no answer clears the policy (fail-open).  So the
    printed policy is the answer to the slot before, if it came within one
    slot; and it may never come: both SUB sockets connect asynchronously
    (the muApp's metrics SUB reconnects on ZMQ's 100 ms interval until the
    app's main binds the PUB, and the agent's weights SUB connects inside
    main), so the first TTIs' messages of either side can be dropped.  Here
    each TTI's metrics go out again until an answer waits on the weights
    socket: the read that follows finds one.  What the app computes, reads
    and prints is unchanged."""

    def send_metrics(self, reports) -> None:
        tti, deadline = self.tti, time.monotonic() + RIC_WAIT_S
        while True:
            self.tti = tti
            super().send_metrics(reports)
            if self._sub_w.poll(RIC_POLL_MS) or time.monotonic() > deadline:
                return


def test_edgeric_in_the_default_loop(tmp_path, monkeypatch, capsys):
    """--edgeric without --sched: the CellProcessor's metrics hub publishes
    every slot through the port's agent to the port's RicMessenger, whose
    MuAppScheduler answers with max_cqi weights; the app prints the last
    policy it read.  The endpoints are tmp_path's, never the defaults; the
    agent waits for each answer (_LockstepAgent), so every read of the
    policy, the last one too, finds one."""
    pytest.importorskip("zmq")
    from srsran_edgeric_5g_tpu_torch.ric import MuAppScheduler, RicMessenger
    tag = uuid.uuid4().hex[:8]
    eps = tuple(f"ipc://{tmp_path}/{n}-{tag}" for n in ("metrics", "weights", "mcs"))
    monkeypatch.setattr(tedg, "EdgericAgent", functools.partial(_LockstepAgent, *eps))
    seen, stop = [], threading.Event()
    msgr = RicMessenger(*eps)

    class Recording:
        def get_metrics(self, blocking=True, timeout_ms=1000):
            tti, ue_data = msgr.get_metrics(blocking, timeout_ms)
            if ue_data:
                seen.append(ue_data)
            return tti, ue_data

        def send_scheduling_weight(self, ran_tti, weights):
            msgr.send_scheduling_weight(ran_tti, weights)

    def ric():
        muapp = MuAppScheduler(Recording(), algorithm="max_cqi")
        while not stop.is_set():
            muapp.step(blocking=True, timeout_ms=50)

    t = threading.Thread(target=ric, daemon=True)
    t.start()
    try:
        for attempt in range(APP_TRIES):
            try:
                code = loopback_app.main(["--edgeric", "--slots", "8", "--device", "cpu",
                                          "--port", str(random.SystemRandom().randrange(
                                              *APP_PORTS))])
                break
            except OSError as e:
                if e.errno != errno.EADDRINUSE or attempt == APP_TRIES - 1:
                    raise
    finally:
        stop.set()
        t.join(5)
        msgr.close()
    out = capsys.readouterr().out
    assert code == 0, out
    assert "edgeric: 8 TTIs published; last policy: weights={" in out, out
    assert seen and all(len(d) == 2 for d in seen)
    assert any(u["cqi"] > 0 for d in seen for u in d.values())


def test_no_jax_no_zmq_no_protobuf():
    """In a child process with pyzmq and protobuf blocked: every port
    module imports (but the generated protobuf module, which needs
    protobuf), two scheduled slots run on the CPU, an EdgeRIC agent raises
    naming pyzmq, and neither JAX nor the JAX package is loaded."""
    code = r"""
import importlib, pkgutil, sys
for name in ("zmq", "google.protobuf"):
    sys.modules[name] = None
import numpy as np
import srsran_edgeric_5g_tpu_torch as pkg
blocked = "srsran_edgeric_5g_tpu_torch.runtime.protobufs.edgeric_pb2"
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in ("mac", "ric", "runtime.edgeric", "loopback_app", "convert"):
    assert pkg.__name__ + "." + name in names, name
for name in names:
    if name == blocked:
        try:
            importlib.import_module(name)
        except ImportError:
            continue
        raise SystemExit("the protobuf module imported without protobuf")
    importlib.import_module(name)
from srsran_edgeric_5g_tpu_torch import config, loopback_app
from srsran_edgeric_5g_tpu_torch.runtime import edgeric
from srsran_edgeric_5g_tpu_torch.runtime.events import RadioEventNotifier
try:
    edgeric.EdgericAgent("ipc:///nonexistent/m", "ipc:///nonexistent/w",
                         "ipc:///nonexistent/c")
except ModuleNotFoundError as e:
    assert e.name == "zmq", e
else:
    raise SystemExit("an agent was built without pyzmq")
cfg = config.PhyConfig()
rng = np.random.default_rng(0)
def radio(slot, td, snr_db):
    return td
args = loopback_app._parser().parse_args(["--sched", "pf", "--slots", "2"])
res = loopback_app.run_scheduled(args, cfg, cfg.cell_config(), radio, None,
                                 RadioEventNotifier(), rng, device="cpu",
                                 log=lambda s: None)
assert res.code == 0 and res.tb_count >= 2 and res.ok_count == res.tb_count, res
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "srsran_edgeric_5g_tpu"))
print("LEAKED", leaked)
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    try:
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=CHILD_TIMEOUT_S, env=env, cwd=str(REPO))
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"the child ran over {CHILD_TIMEOUT_S} s and was killed:\n"
                    f"{e.stdout}\n{e.stderr}")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
