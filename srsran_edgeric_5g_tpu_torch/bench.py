"""The benchmark entry of the port: the root ``bench.py``'s modes on
PyTorch, one JSON line per run.

Run from the root of a checkout:

    python -m srsran_edgeric_5g_tpu_torch.bench [flags]

The flags are ``bench.py``'s: ``--sbatch=N`` (slots per call, 256),
``--iters=N`` (chained steps timed, 30), ``--cells=N``, ``--mimo=L``,
``--mimo-full=L``, ``--streaming=S``, ``--data-only``, ``--no-csirs``,
``--qam256`` (with ``--chest=ls``) and ``--clean``; ``--device`` (``cuda``
by default, ``cpu`` runs the plain versions) is the port's own.  ``--fft=``
is refused: ``ofdm.set_fft_impl`` is a TPU FFT A/B with no counterpart
here.  The environment switches ``BENCH_NUM_ITERS``, ``BENCH_NO_CARRY``
and ``BENCH_NO_EARLYSTOP`` act on the full-cell mode as in ``bench.py``.

Each mode builds its inputs (payloads, DCIs, MIBs, ACK and CSI bits and the
MIMO channels from ``np.random.default_rng(0)`` in ``bench.py``'s draw
order, so they equal its arrays), checks ``bench.py``'s asserts on the
setup step, and times chained steps as ``bench.py`` chains them: the
payload XORed with ``eps``, the noise sign flipped every step, the int8
HARQ carry fed back, the DL transmit reduced into ``eps`` through its full
power.  Wall clock over the steps, one synchronisation at the end.  It
prints ``bench.py``'s line, {"metric", "value", "unit", "vs_baseline"},
on stdout and its ``# chained timing`` line on stderr.  A failed check or
launch exits non-zero; there is no retry.

``bench_streaming`` is the bounded-latency operating point: batches of a
few slots submitted double-buffered (the step for batch k+1 is issued
before the host waits on batch k), each batch's latency from its submit to
its CUDA event, and no host synchronisation inside a step
(``host_syncs`` lists the ones a step makes).
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import inspect
import json
import math
import os
import sys
import time
import traceback
import warnings

import numpy as np
import torch

from .device import resolve_device
from .parallel import full_cell as fcm
from .parallel import slot_pipeline as sp

ITERS = 30
SNR_DB = 25.0
# bench.py --qam256: TS 38.214 Table 5.1.3.1-2 MCS 20 (Qm 8, R 682.5/1024)
# both ways at 33 dB, the TA + smoothing estimator unless --chest=ls.
QAM256_SNR_DB = 33.0
QAM256_KW = dict(dl_modulation="qam256", ul_modulation="qam256",
                 dl_target_rate=682.5 / 1024, ul_target_rate=682.5 / 1024)
# The AWGN's generator.  bench.py draws it with jax.random.key(42); those
# draws cannot be reproduced in PyTorch, so the port draws the same shapes
# from a CPU torch.Generator with this seed, the same on every device.
NOISE_SEED = 42
STREAM_DEPTH = 2
STREAM_BATCHES = 400
STREAM_COMPUTE_STEPS = 30   # bench_streaming's deep-chained k
UNIT = "samples/s/chip (20MHz 4UE DL+UL)"


def require(cond, msg: str) -> None:
    """bench.py's ``assert``, kept under ``python -O``."""
    if not cond:
        raise AssertionError(msg)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main_cell(n_layers: int = 1) -> sp.CellConfig:
    """bench.py's data-plane cell: 20 MHz, 106 PRB, 4 UEs x 26 PRB, 64QAM
    r0.5."""
    return sp.CellConfig(nof_prb=106, nfft=1536, nof_ue=4, prb_per_ue=26,
                         modulation="qam64", target_rate=0.5,
                         n_layers=n_layers)


def _bits(rng: np.random.Generator, shape, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(rng.integers(0, 2, shape, dtype=np.int8), device=dev)


def mix_matrix(rng: np.random.Generator, n: int, dev: torch.device) -> torch.Tensor:
    """bench.py's well-conditioned static LxL channel: 0.35 (N(0,1) +
    jN(0,1))/sqrt(2) plus the DFT matrix / sqrt(L)."""
    a = ((rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))) / np.sqrt(2))
    f = np.exp(-2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n)
    return torch.as_tensor((0.35 * a + f / np.sqrt(n)).astype(np.complex64),
                           device=dev)


def awgn(td: torch.Tensor, snr_db: float | None) -> torch.Tensor | None:
    """AWGN at ``snr_db`` under the mean sample power of ``td`` (None:
    none), from NOISE_SEED."""
    if snr_db is None:
        return None
    sig_pow = (td.real * td.real + td.imag * td.imag).mean()
    sigma = torch.sqrt(sig_pow * 10.0 ** (-snr_db / 10.0) / 2.0)
    gen = torch.Generator().manual_seed(NOISE_SEED)
    n = torch.randn(tuple(td.shape) + (2,), generator=gen).to(td.device) * sigma
    return torch.complex(n[..., 0], n[..., 1])


def _noisy(x: torch.Tensor, noise, flip: torch.Tensor) -> torch.Tensor:
    return x if noise is None else x + noise * flip


def _start(dev: torch.device):
    """(eps, flip): the chain's first XOR word and noise sign."""
    return (torch.zeros((), dtype=torch.int8, device=dev),
            torch.ones((), device=dev))


# ===================================================== full gNB slot

def full_cell_inputs(fc: fcm.FullCellConfig, s: int, snr_db: float | None,
                     device) -> dict:
    """bench.py's full-cell inputs at ``s`` slots: from default_rng(0) the
    DL payloads of the normal and the SSB slots, the DCIs, the MIBs, the UL
    payloads, ACK and CSI bits (and at fc.n_layers > 1 the LxL channel);
    the UE UL generated once (mixed through that channel), its AWGN, the
    HARQ carry of zeros, new_data = 1, and the gNB calls of the
    configuration."""
    dev = resolve_device(device)
    mimo, u = fc.n_layers > 1, fc.nof_ue
    rng = np.random.default_rng(0)
    cell_u = fc.ul_cell()
    cell_n, cell_s = ((fc.dl_cell_mimo(), fc.dl_cell_ssb_mimo()) if mimo
                      else (fc.dl_cell(), fc.dl_cell_ssb()))
    seg, rm = sp._plans(cell_u)
    x = dict(cell_u=cell_u, cell_n=cell_n, cell_s=cell_s, seg=seg, rm=rm,
             pay_n=_bits(rng, (len(fc.norm_slots(s)), u, cell_n.derived_tbs()), dev),
             pay_s=_bits(rng, (len(fc.ssb_slots(s)), u, cell_s.derived_tbs()), dev),
             dci=_bits(rng, (s, 2 * u, fc.dci_bits), dev),
             pbch=_bits(rng, (len(fc.ssb_slots(s)), 24), dev),
             pay_u=_bits(rng, (s, u, cell_u.derived_tbs()), dev),
             ack=_bits(rng, (s, u, 2), dev),
             csi=_bits(rng, (len(fc.csi_slots(s)), u, fc.csi_bits), dev))
    if mimo:
        mix = mix_matrix(rng, fc.n_layers, dev)
        x.update(gnb_dl=fcm.gnb_dl_slot_batch_mimo, gnb_ul=fcm.gnb_ul_slot_batch_mimo,
                 ul=torch.einsum("pl,slt->spt", mix, fcm.ue_ul_slot_batch_mimo(
                     x["pay_u"], x["ack"], x["csi"], fc, s, device=dev)))
    else:
        x.update(gnb_dl=fcm.gnb_dl_slot_batch, gnb_ul=fcm.gnb_ul_slot_batch,
                 ul=fcm.ue_ul_slot_batch(x["pay_u"], x["ack"], x["csi"], fc, s,
                                         device=dev))
    x.update(noise=awgn(x["ul"], snr_db), ones=torch.ones((s, u), device=dev),
             soft0=torch.zeros((s * u * seg.c, rm.n_cb), dtype=torch.int8,
                               device=dev))
    return x


def full_cell_step(x: dict, fc: fcm.FullCellConfig, s: int, device,
                   num_iters: int | None = None, carry: bool = True,
                   early_stop: bool = True):
    """bench.py's chained full-cell step, ``step(pn, ps, eps, flip, soft)
    -> (res, eps_next, -flip, td)``: the DL slot batch of the payloads
    XORed with ``eps`` and its power, the UL slot batch of the noisy UL
    (the noise times ``flip``) with the HARQ carry ``soft`` (``carry``:
    fed back with new_data = 1, else none), and ``eps_next`` = 0 made from
    both."""
    dev = resolve_device(device)
    kw = {} if num_iters is None else {"num_iters": num_iters}
    gnb_dl, gnb_ul = x["gnb_dl"], x["gnb_ul"]

    def step(pn, ps, eps, flip, soft):
        td = gnb_dl(pn ^ eps, ps, x["dci"], x["pbch"], fc, s, device=dev)
        dl_pow = (td.real ** 2 + td.imag ** 2).mean()
        res = gnb_ul(_noisy(x["ul"], x["noise"], flip), fc, s,
                     soft_in=soft if carry else None,
                     new_data=x["ones"] if carry else None, soft_flat=True,
                     early_stop=early_stop, device=dev, **kw)
        eps_next = (res["payload"][0, 0, 0] & 0) | (dl_pow > 1e30).to(torch.int8)
        return res, eps_next, -flip, td

    return step


def full_cell_asserts(res: dict, x: dict) -> None:
    """bench.py's asserts on a full-cell step: every PUSCH TB passes CRC
    with its payload, the F1 ACKs and the F2 CSI are exact and valid, and
    PRACH preamble 7 alone is detected on every occasion."""
    ok = res["tb_ok"]
    require(bool(ok.all()), f"PUSCH CRC failed: {int(ok.sum())}/{ok.numel()}")
    require(torch.equal(res["payload"], x["pay_u"]), "PUSCH payload mismatch")
    require(torch.equal(res["ack_bits"], x["ack"]), "PUCCH F1 ACK mismatch")
    require(bool(res["csi_ok"].all()), "PUCCH F2 CSI not valid")
    require(torch.equal(res["csi_bits"], x["csi"]), "PUCCH F2 CSI mismatch")
    det = res["prach_detected"]
    others = torch.ones(det.shape[-1], dtype=torch.bool, device=det.device)
    others[7] = False
    require(bool(det[:, 7].all()) and not bool(det[:, others].any()),
            f"PRACH detection wrong: {torch.nonzero(det).tolist()[:8]}")


def _timed(fn, iters: int, dev: torch.device) -> float:
    """Seconds of ``iters`` calls of ``fn``, one synchronisation at the end."""
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize(dev)
    return time.perf_counter() - t0


def chained(step, state: tuple, steps: int, dev: torch.device):
    """A data-plane step, ``step(eps, flip) -> (res, eps_next, -flip,
    ...)``, chained ``steps`` times from ``state`` = (eps, flip): (the last
    result, the state after it, seconds with one synchronisation at the
    end)."""
    out = [None, *state]

    def advance():
        out[:] = step(*out[1:3])[:3]

    seconds = _timed(advance, steps, dev)
    return out[0], tuple(out[1:]), seconds


class FullCellChain:
    """The full-cell step chained as bench.py chains it; ``res`` and ``td``
    are the last step's results."""

    def __init__(self, fc: fcm.FullCellConfig, s: int, snr_db: float | None,
                 device, **step_kw):
        self.dev = resolve_device(device)
        self.fc, self.s = fc, s
        self.x = full_cell_inputs(fc, s, snr_db, self.dev)
        self.step = full_cell_step(self.x, fc, s, self.dev, **step_kw)
        self.eps, self.flip = _start(self.dev)
        self.res, self.td = None, None

    def __call__(self) -> dict:
        soft = self.x["soft0"] if self.res is None else self.res["soft"]
        self.res, self.eps, self.flip, self.td = self.step(
            self.x["pay_n"], self.x["pay_s"], self.eps, self.flip, soft)
        return self.res

    def timed(self, iters: int) -> float:
        """Seconds per slot of ``iters`` chained steps."""
        return _timed(self, iters, self.dev) / (iters * self.s)

    def desc(self) -> str:
        x, u = self.x, self.fc.nof_ue
        tbs = (x["cell_n"].derived_tbs(), x["cell_s"].derived_tbs(),
               x["cell_u"].derived_tbs())
        return f"TBS dl {tbs[0]}/{tbs[1]} ul {tbs[2]} x {u} UE"


def bench_full_cell(s_batch: int, snr_db: float | None, fc_kw: dict | None = None,
                    iters: int = ITERS, device="cuda"):
    """bench.py's default mode: the full gNB slot, DL TX + UL RX of every
    channel, S = ``s_batch`` slots per step."""
    fc = fcm.FullCellConfig(**(fc_kw or {}))
    num_iters = int(os.environ.get("BENCH_NUM_ITERS", "0")) or None
    chain = FullCellChain(fc, s_batch, snr_db, device, num_iters=num_iters,
                          carry=os.environ.get("BENCH_NO_CARRY") != "1",
                          early_stop=os.environ.get("BENCH_NO_EARLYSTOP") != "1")
    full_cell_asserts(chain(), chain.x)
    slot_s = chain.timed(iters)
    u, seg, rm = fc.nof_ue, chain.x["seg"], chain.x["rm"]
    return slot_s, fc.timing, (
        f"full gNB slot, S={s_batch}: {chain.desc()}; 8 DCI/slot, SSB/10, "
        f"F1/slot, F2/5, SRS/10, PRACH/10; HARQ soft carry "
        f"{s_batch}x{u * seg.c}x{rm.n_cb}")


def bench_full_cell_mimo(s_batch: int, n_layers: int, snr_db: float | None,
                         fc_kw: dict | None = None, iters: int = ITERS,
                         device="cuda"):
    """bench.py's --mimo-full=L: the full gNB slot with PDSCH / PUSCH at L
    layers per UE through the LxL channel."""
    fc = fcm.FullCellConfig(n_layers=n_layers, **(fc_kw or {}))
    chain = FullCellChain(fc, s_batch, snr_db, device)
    full_cell_asserts(chain(), chain.x)
    slot_s = chain.timed(iters)
    return slot_s, fc.timing, (
        f"FULL gNB slot, {n_layers}x{n_layers} MIMO data plane, S={s_batch}: "
        f"{chain.desc()} ({n_layers} layers); 8 DCI/slot, SSB/10, F1/slot, "
        f"F2/5, SRS/10, PRACH/10; HARQ carry")


# ========================================================== streaming

class _HostDone:
    """A CPU step is done when it returns: the stand-in of a CUDA event."""

    def synchronize(self) -> None:
        pass


def _done_event(dev: torch.device):
    if dev.type != "cuda":
        return _HostDone()
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def stream_batches(submit, n_batches: int, depth: int, dev: torch.device):
    """Submit ``n_batches`` batches ``depth`` deep: ``submit()`` issues
    one batch and returns its result, which stays referenced until the
    batch is complete; batch k+1 is issued before the host waits on batch
    k.  Returns (latency in seconds of each batch from its submit to its
    completion, the window's wall seconds)."""
    inflight: collections.deque = collections.deque()
    lat = []

    def complete():
        t_sub, ev, _ = inflight.popleft()
        ev.synchronize()
        lat.append(time.perf_counter() - t_sub)

    t_start = time.perf_counter()
    for _ in range(n_batches):
        t_sub = time.perf_counter()
        out = submit()
        inflight.append((t_sub, _done_event(dev), out))
        if len(inflight) >= depth:
            complete()
    while inflight:
        complete()
    return np.asarray(lat), time.perf_counter() - t_start


@dataclasses.dataclass
class StreamRun:
    """One streaming run: ``s`` slots per batch ``depth`` deep over
    ``n_batches`` batches; the chain, left after the streaming window
    (``carry``: the HARQ carry then) and the compute decomposition."""

    s: int
    depth: int
    n_batches: int
    latency_ms: np.ndarray
    wall_s: float
    compute_ms: float
    carry: torch.Tensor
    chain: FullCellChain

    @property
    def slot_s(self) -> float:
        return self.wall_s / (self.n_batches * self.s)

    @property
    def x_real_time(self) -> float:
        return (1.0 / (1 << self.chain.fc.mu)) * 1e-3 / self.slot_s

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.latency_ms, q))

    def desc(self) -> str:
        p50, p99 = self.percentile(50), self.percentile(99)
        return (f"STREAMING full gNB slot, S={self.s} depth={self.depth}: "
                f"sustained {1e-3 / self.slot_s:.2f}x real-time; batch latency "
                f"p50 {p50:.2f} ms / p99 {p99:.2f} ms (run-ahead budget = "
                f"{p99 + self.s:.1f} ms incl. the {self.s} ms batch fill); "
                f"decomposition: program compute {self.compute_ms:.2f} ms/batch, "
                f"submit->result overhead {p50 - self.compute_ms:.2f} ms "
                f"(dispatch + queueing)")


def stream(s_batch: int, snr_db: float | None, depth: int = STREAM_DEPTH,
           n_batches: int = STREAM_BATCHES, fc_kw: dict | None = None,
           compute_steps: int = STREAM_COMPUTE_STEPS, device="cuda") -> StreamRun:
    """bench.py's streaming loop on the port: the setup step and its CRC
    check, ``n_batches`` full-cell batches of ``s_batch`` slots submitted
    ``depth`` deep, then ``compute_steps`` deep-chained steps with one
    synchronisation at the end (the program's time per batch; p50 minus it
    is the submit -> result overhead)."""
    fc = fcm.FullCellConfig(**(fc_kw or {}))
    # bench.py: ``snr_db or 25.0`` (--clean streams at 25 dB).
    chain = FullCellChain(fc, s_batch, snr_db or SNR_DB, device)
    require(bool(chain()["tb_ok"].all()), "streaming setup step: PUSCH CRC failed")
    lat, wall = stream_batches(chain, n_batches, depth, chain.dev)
    carry = chain.res["soft"]
    compute_ms = (_timed(chain, compute_steps, chain.dev) / compute_steps * 1e3
                  if compute_steps else math.nan)
    return StreamRun(s=s_batch, depth=depth, n_batches=n_batches,
                     latency_ms=lat * 1e3, wall_s=wall, compute_ms=compute_ms,
                     carry=carry, chain=chain)


def bench_streaming(s_batch: int, snr_db: float | None, depth: int = STREAM_DEPTH,
                    n_batches: int = STREAM_BATCHES, fc_kw: dict | None = None,
                    device="cuda"):
    """bench.py's --streaming=S: sustained x real time and the p50 / p99
    batch latency of the full gNB slot streamed ``depth`` deep."""
    run = stream(s_batch, snr_db, depth, n_batches, fc_kw, device=device)
    return run.slot_s, run.chain.fc.timing, run.desc()


def host_syncs(fn) -> list[str]:
    """The synchronising CUDA calls that ``fn()`` makes (it runs once under
    ``torch.cuda.set_sync_debug_mode("warn")``), each as the file:line of
    the innermost frame of this package that made it."""
    found: list[str] = []
    running = False
    pkg = os.path.dirname(os.path.abspath(__file__))

    def hook(message, category, filename, lineno, file=None, line=None):
        if not running or "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]        # without this hook
        frames = [f for f in stack if os.path.abspath(f.filename).startswith(pkg)]
        f = (frames or stack)[-1]
        found.append(f"{os.path.relpath(f.filename, os.path.dirname(pkg))}:"
                     f"{f.lineno} ({f.name})")

    gc.collect()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            running = True
            fn()
        finally:
            running = False
            torch.cuda.set_sync_debug_mode("default")
    return found


# ========================================================= data planes

def mimo_inputs(s: int, n_layers: int, snr_db: float | None, device) -> dict:
    """bench_mimo's inputs: from default_rng(0) the payloads and the LxL
    channel; the AWGN under the mean power of the unmixed DL."""
    dev = resolve_device(device)
    cell = main_cell(n_layers)
    rng = np.random.default_rng(0)
    payloads = _bits(rng, (s, cell.nof_ue, cell.derived_tbs()), dev)
    rntis = torch.as_tensor(0x4601 + np.arange(cell.nof_ue), device=dev)
    mix = mix_matrix(rng, n_layers, dev)
    noise = (awgn(sp.dl_slot_batch_mimo(payloads, rntis, cell, device=dev), snr_db)
             if snr_db is not None else None)
    return dict(cell=cell, payloads=payloads, rntis=rntis, mix=mix, noise=noise)


def mimo_step(x: dict, device):
    """bench_mimo's chained step, ``step(eps, flip) -> (res, eps_next,
    -flip, rx)``: the multi-layer DL, the channel, the noise times
    ``flip``, the multi-antenna UL."""
    dev = resolve_device(device)
    cell, payloads, rntis = x["cell"], x["payloads"], x["rntis"]

    def step(eps, flip):
        td = sp.dl_slot_batch_mimo(payloads ^ eps, rntis, cell, device=dev)
        rx = _noisy(torch.einsum("pl,slt->spt", x["mix"], td), x["noise"], flip)
        res = sp.ul_slot_batch_mimo(rx, rntis, cell, device=dev)
        return res, res[0][0, 0, 0] & 0, -flip, rx

    return step


def wire_floor(res, rx: torch.Tensor, x: dict) -> tuple[int, int]:
    """bench.py's assert on the multi-layer data plane, held against the
    reference decoder's own outcome (ROADMAP.md Queue C: its wire decode,
    which K1 reproduces bit for bit, leaves some 4x4 TBs undecoded where
    its f32 layered min-sum decodes them; at bench.py's own 4x4 draw 3.6 %
    of the TBs, so bench.py's assert fails in the reference too).  Every TB
    that passes CRC carries its exact payload, and the f32 decode of the
    same decoder input (``rx``, the step's received samples) recovers every
    TB, so the front delivered the information and each failure is the
    wire decoder's.  Returns (the TBs that failed CRC, the TBs whose CRC
    outcome differs from whether every codeblock of theirs met parity in
    the wire decode)."""
    from .ops.ldpc import decoder, segmenter
    cell, payloads = x["cell"], x["payloads"]
    pay_hat, ok = res[0], res[1]
    require(torch.equal(pay_hat[ok], payloads[ok]),
            "MIMO loopback: payload mismatch on a TB that passed CRC")
    n_fail = int((~ok).sum())
    if n_fail == 0:
        return 0, 0
    seg, _ = sp._plans(cell)
    full = sp._decoder_input(sp._ul_front_mimo(rx, x["rntis"], cell)[0], cell)
    _, cb_ok = decoder.decode(full, seg.bg, seg.zc, schedule="wire_auto")
    parity = cb_ok.reshape(-1, seg.c).all(dim=1).reshape(ok.shape)
    hard, _ = decoder.decode(full.float() / 6.0, seg.bg, seg.zc, schedule="auto")
    pay_f32, ok_f32 = segmenter.desegment_tb(hard, seg)
    require(bool(ok_f32.all()) and torch.equal(pay_f32.reshape(payloads.shape),
                                               payloads),
            f"MIMO loopback CRC failed: {n_fail}/{ok.numel()} TBs, and the f32 "
            f"decoder does not recover every TB")
    return n_fail, int((parity != ok).sum())


def bench_mimo(s_batch: int, n_layers: int, snr_db: float | None,
               iters: int = ITERS, device="cuda"):
    """bench.py's --mimo=L: the multi-layer data plane (one codeword per
    UE, CDM DM-RS, LxP MMSE) through the LxL channel."""
    dev = resolve_device(device)
    x = mimo_inputs(s_batch, n_layers, snr_db, dev)
    step = mimo_step(x, dev)
    res, eps, flip, rx = step(*_start(dev))
    n_fail, mismatch = wire_floor(res, rx, x)
    slot_s = chained(step, (eps, flip), iters, dev)[2] / (iters * s_batch)
    floor = (f"; {n_fail} TBs at the wire-decode floor ({mismatch} TBs' CRC "
             f"unlike their codeblocks' parity)" if n_fail else "")
    return slot_s, x["cell"].timing, (
        f"{n_layers}x{n_layers} MIMO data plane, S={s_batch}, TBS "
        f"{x['cell'].derived_tbs()} x 4 UE (single codeword, {n_layers} "
        f"layers, LxP MMSE){floor}")


def data_plane_inputs(s: int, n_cells: int, snr_db: float | None, device) -> dict:
    """bench_data_plane's inputs: the payloads from default_rng(0), each
    carrier's RNTIs (0x4601 + arange(4 * n_cells) by carrier), the AWGN
    under the mean power of the DL."""
    dev = resolve_device(device)
    cell = main_cell()
    rng = np.random.default_rng(0)
    tbs = cell.derived_tbs()
    payloads = _bits(rng, (s, 4, tbs) if n_cells == 1 else (n_cells, s, 4, tbs), dev)
    rntis = torch.as_tensor(0x4601 + np.arange(4 * n_cells), device=dev)
    if n_cells > 1:
        rntis = rntis.reshape(n_cells, 4)
    dl = sp.dl_slot_batch if n_cells == 1 else sp.multi_cell_dl_slot_batch
    ul = sp.ul_slot_batch if n_cells == 1 else sp.multi_cell_ul_slot_batch
    noise = (awgn(dl(payloads, rntis, cell, device=dev), snr_db)
             if snr_db is not None else None)
    return dict(cell=cell, payloads=payloads, rntis=rntis, noise=noise, dl=dl, ul=ul)


def data_plane_step(x: dict, device):
    """bench_data_plane's chained step, ``step(eps, flip) -> (res,
    eps_next, -flip)``: the DL of the payloads XORed with ``eps``, the noise
    times ``flip``, the UL."""
    dev = resolve_device(device)
    cell, payloads, rntis = x["cell"], x["payloads"], x["rntis"]

    def step(eps, flip):
        td = _noisy(x["dl"](payloads ^ eps, rntis, cell, device=dev), x["noise"], flip)
        res = x["ul"](td, rntis, cell, device=dev)
        return res, res[0].flatten()[0] & 0, -flip

    return step


def data_plane_asserts(res, x: dict) -> None:
    """bench.py's asserts on the data plane: every TB passes CRC with its
    payload."""
    ok = res[1]
    require(bool(ok.all()), f"loopback CRC failed: {int((~ok).sum())} of "
                            f"{ok.numel()} TBs")
    require(torch.equal(res[0], x["payloads"]), "loopback payload mismatch")


def bench_data_plane(s_batch: int, n_cells: int, snr_db: float | None,
                     iters: int = ITERS, device="cuda"):
    """bench.py's --data-only and --cells=N: the data plane alone (PDSCH
    and PUSCH, no control), N > 1 carriers flattened into one call."""
    dev = resolve_device(device)
    x = data_plane_inputs(s_batch, n_cells, snr_db, dev)
    step = data_plane_step(x, dev)
    res, eps, flip = step(*_start(dev))
    data_plane_asserts(res, x)
    slot_s = chained(step, (eps, flip), iters, dev)[2] / (iters * s_batch * n_cells)
    return slot_s, x["cell"].timing, (
        f"data-plane only, S={s_batch} x {n_cells} cell(s), "
        f"TBS {x['cell'].derived_tbs()} x 4 UE")


# =============================================================== modes

@dataclasses.dataclass(frozen=True)
class Mode:
    """One run of bench.py's: the function and its arguments, the
    full-cell overrides, the chained steps timed, the metric's name."""

    fn: object
    args: tuple
    fc_kw: dict
    iters: int
    metric: str
    device: str = "cuda"

    def run(self):
        """(seconds per slot, slot timing, description)."""
        params = inspect.signature(self.fn).parameters
        kw = {"device": self.device}
        if "fc_kw" in params:
            kw["fc_kw"] = dict(self.fc_kw)
        if "iters" in params:
            kw["iters"] = self.iters
        return self.fn(*self.args, **kw)


def parse(argv) -> Mode:
    """The mode that bench.py's ``main`` runs for ``argv`` (the arguments
    without the program's name), and ``--device``."""
    argv = list(argv)
    s_batch, n_cells, mimo, mimo_full, streaming, iters = 256, 1, 0, 0, 0, ITERS
    device = "cuda"
    for i, a in enumerate(argv):
        if a.startswith("--sbatch="):
            s_batch = int(a.split("=")[1])
        if a.startswith("--iters="):
            iters = int(a.split("=")[1])
        if a.startswith("--cells="):
            n_cells = int(a.split("=")[1])
        if a.startswith("--mimo="):
            mimo = int(a.split("=")[1])
        if a.startswith("--mimo-full="):
            mimo_full = int(a.split("=")[1])
        if a.startswith("--streaming="):
            streaming = int(a.split("=")[1])
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        if a == "--device" and i + 1 < len(argv):
            device = argv[i + 1]
        if a.startswith("--fft="):
            raise SystemExit("bench: --fft= selects ofdm.set_fft_impl, a TPU FFT "
                             "A/B of the JAX package with no counterpart in the "
                             "port (ROADMAP.md Queue A); the port's OFDM is "
                             "torch.fft")
    fc_kw: dict = {}
    if "--no-csirs" in argv:
        fc_kw.update(csi_rs_period=0)
    qam256 = "--qam256" in argv
    if qam256:
        fc_kw.update(QAM256_KW)
        if "--chest=ls" not in argv:
            fc_kw.update(ul_delay_spread_us=1.0)
    snr_db = None if "--clean" in argv else (QAM256_SNR_DB if qam256 else SNR_DB)

    if streaming:
        fn, args = bench_streaming, (streaming, snr_db)
        metric = "streaming_full_gnb_slot_samples_per_sec"
    elif mimo_full:
        fn, args = bench_full_cell_mimo, (s_batch, mimo_full, snr_db)
        metric = f"full_gnb_slot_mimo{mimo_full}x{mimo_full}_samples_per_sec"
    elif mimo:
        fn, args = bench_mimo, (s_batch, mimo, snr_db)
        metric = f"mimo{mimo}x{mimo}_slot_samples_per_sec"
    elif "--data-only" in argv or n_cells > 1:
        fn, args = bench_data_plane, (s_batch, n_cells, snr_db)
        metric = "slot_pipeline_samples_per_sec"
    else:
        fn, args = bench_full_cell, (s_batch, snr_db)
        metric = "full_gnb_slot_samples_per_sec"
    if qam256:
        metric += "_qam256"
    return Mode(fn=fn, args=args, fc_kw=fc_kw, iters=iters, metric=metric,
                device=device)


def result_line(metric: str, slot_s: float, timing) -> dict:
    """bench.py's JSON line for ``slot_s`` seconds per slot."""
    slot_samples = timing.cp.total             # 23040 at 20 MHz
    samples_per_sec = slot_samples / slot_s
    realtime = slot_samples * 1000.0           # 1 ms slots: 23.04 Msps
    return {"metric": metric, "value": round(samples_per_sec, 1), "unit": UNIT,
            "vs_baseline": round(samples_per_sec / realtime, 3)}


def main(argv=None) -> int:
    mode = parse(sys.argv[1:] if argv is None else argv)
    slot_s, timing, desc = mode.run()
    print(json.dumps(result_line(mode.metric, slot_s, timing)), flush=True)
    print(f"# chained timing, {desc}; {slot_s * 1e3:.3f} ms/slot",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
