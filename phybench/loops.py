"""The window's loops.

* ``batch_window``: a closed loop, one step after another for ``seconds``
  of host time, then one synchronisation; every slot of every step counts.
* ``open_loop``: slots arrive at the air rate whatever the system does.
  Slot k is in hand at t0 + (k + 1) slot durations; batch b of S slots is
  due when its last slot is in hand, at t0 + (b + 1) S slot durations, and
  is submitted then, at most ``depth`` batches in flight (the oldest is
  waited for first).  A batch's latency runs from its due time to the
  moment its results are in host memory, read on the device clock against
  a mark recorded at t0.  The generator's lateness is how far past its due
  time a batch was submitted.
* ``closed_stream``: the stream sweep's closed loop, each batch submitted
  as soon as one of ``depth`` in flight completes.

Clock, sleep and the completion marks are arguments, so the arithmetic runs
on a fake clock in the tests.
"""

from __future__ import annotations

import collections
import dataclasses
import time


def batch_window(step, seconds: float, sync, clock=time.perf_counter):
    """Steps until ``seconds`` of host time have passed, then ``sync()``:
    (the window's wall seconds, each step's host issue seconds, each
    step's return time from the window's start)."""
    issue, ends = [], []
    sync()
    t0 = clock()
    end = t0 + seconds
    while True:
        a = clock()
        step()
        b = clock()
        issue.append(b - a)
        ends.append(b - t0)
        if b >= end:
            break
    sync()
    return clock() - t0, issue, ends


class HostMarks:
    """Completion marks on the host clock: a batch is done when its submit
    returns (the CPU runs each step before returning)."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.t0 = None

    def begin(self) -> None:
        self.t0 = self.clock()

    def mark(self):
        return _HostMark((self.clock() - self.t0) * 1e3)


@dataclasses.dataclass
class _HostMark:
    ms: float

    def wait(self) -> None:
        pass

    def done_ms(self) -> float:
        return self.ms


class CudaMarks:
    """Completion marks on the device clock: CUDA events recorded on the
    current stream, timed against the one recorded at ``begin``."""

    def __init__(self):
        import torch
        self._torch = torch
        self.start = torch.cuda.Event(enable_timing=True)

    def begin(self) -> None:
        self.start.record()

    def mark(self):
        ev = self._torch.cuda.Event(enable_timing=True)
        ev.record()
        return _CudaMark(self.start, ev)


@dataclasses.dataclass
class _CudaMark:
    start: object
    ev: object

    def wait(self) -> None:
        self.ev.synchronize()

    def done_ms(self) -> float:
        return self.start.elapsed_time(self.ev)


@dataclasses.dataclass
class StreamResult:
    latency_ms: list[float]     # per batch, from its due time to its results
    lateness_ms: list[float]    # per batch, its submit past its due time
    issue_s: list[float]        # per batch, the host time of its submit
    wall_s: float               # t0 to the last completion


def wait_until(deadline: float, clock=time.perf_counter, sleep=time.sleep) -> None:
    """Sleep to half a millisecond before ``deadline``, then spin."""
    rest = deadline - clock() - 5e-4
    if rest > 0:
        sleep(rest)
    while clock() < deadline:
        pass


def open_loop(submit, marks, n_batches: int, period_s: float, depth: int,
              clock=time.perf_counter, until=None) -> StreamResult:
    """``n_batches`` batches due every ``period_s`` from t0; ``submit(b)``
    issues batch b and returns its completion mark (``marks.mark()``)."""
    until = until or (lambda t: wait_until(t, clock))
    inflight: collections.deque = collections.deque()
    due_ms, lateness, issue, done = [], [], [], {}
    t0 = clock()
    marks.begin()
    for b in range(n_batches):
        due = t0 + (b + 1) * period_s
        if len(inflight) >= depth:
            k, m = inflight.popleft()
            m.wait()
            done[k] = m
        until(due)
        now = clock()
        lateness.append((now - due) * 1e3)
        due_ms.append((due - t0) * 1e3)
        inflight.append((b, submit(b)))
        issue.append(clock() - now)
    while inflight:
        k, m = inflight.popleft()
        m.wait()
        done[k] = m
    wall = clock() - t0
    lat = [done[b].done_ms() - due_ms[b] for b in range(n_batches)]
    return StreamResult(latency_ms=lat, lateness_ms=lateness, issue_s=issue,
                        wall_s=wall)


def closed_stream(submit, marks, n_batches: int, depth: int,
                  clock=time.perf_counter) -> float:
    """``n_batches`` batches, each submitted as soon as fewer than ``depth``
    are in flight: the wall seconds from the first submit to the last
    completion."""
    inflight: collections.deque = collections.deque()
    marks.begin()
    t0 = clock()
    for b in range(n_batches):
        if len(inflight) >= depth:
            inflight.popleft().wait()
        inflight.append(submit(b))
    while inflight:
        inflight.popleft().wait()
    return clock() - t0
