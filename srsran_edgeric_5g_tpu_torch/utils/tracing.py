"""Chrome trace-event tracing for the slot pipeline, and the build counter.

Copy of ``srsran_edgeric_5g_tpu/utils/tracing.py`` (plain Python), on the
profiler's clock.  Counterpart of the reference's file_event_tracer /
l1_tracer (srsRAN-5G-ER/lib/instrumentation/, usage e.g.
uplink_processor_impl.cpp:83) which writes Chrome trace-event JSON; the
output loads in chrome://tracing / Perfetto like the reference's traces.

A span is a ``torch.profiler.record_function`` range whenever a torch
profiler is recording, so the device operations launched inside it fall
under it in the profiler's (CUPTI) trace; an enabled tracer also records
its own event.  Both stamp the Unix-epoch clock: the tracer's ``ts`` is in
microseconds from the ``baseTimeNanoseconds`` that ``write`` puts in the
file header, as in the profiler's Chrome trace, so the two files lie on one
timeline.  With neither on, a span is a flag check and a shared no-op
context: ``record_function`` is never entered then, since it costs
microseconds a call whether or not a profiler records.

``builds`` counts the program's cached table builders: ``cached_build`` in
place of ``functools.lru_cache(maxsize=None)`` records each miss and its
exclusive host seconds (its own, less the nested builders') under the
builder's name; the CUDA build adds nvcc's seconds as ``nvcc.<kernel>``,
and a full-slot entry point's graph capture its seconds as
``graph.<entry point>`` (``parallel/step_graph.py``).  ``graph_calls``
counts how each call of those entry points ran: captured, replayed, or
eager and why.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("tracer", "name", "args", "range", "start")

    def __init__(self, tracer: "EventTracer", name: str, args: dict):
        self.tracer, self.name, self.args = tracer, name, args
        self.range = self.start = None

    def __enter__(self):
        if _profiler_enabled():
            self.range = record_function(self.name)
            self.range.__enter__()
        if self.tracer._enabled:
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.start is not None:
            end = time.time_ns()
            self.tracer._record({"name": self.name, "ph": "X",
                                 "ts": self.tracer._us(self.start),
                                 "dur": (end - self.start) * 1e-3,
                                 "args": self.args})
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class EventTracer:
    """Collects complete ('X') trace events; disabled unless started."""

    def __init__(self):
        self._events: list[dict] = []
        self._enabled = False
        self._lock = threading.Lock()
        self._base_ns = time.time_ns()

    def enable(self):
        self._enabled = True
        self._base_ns = time.time_ns()

    def disable(self):
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    def span(self, name: str, **args):
        """A context for one stage: a profiler range while a profiler
        records, an event while the tracer is enabled, else nothing."""
        if not self._enabled and not _profiler_enabled():
            return _OFF
        return _Span(self, name, args)

    def instant(self, name: str, **args):
        if not self._enabled:
            return
        self._record({"name": name, "ph": "i", "s": "t",
                      "ts": self._us(time.time_ns()), "args": args})

    def _us(self, ns: int) -> float:
        return (ns - self._base_ns) * 1e-3

    def _record(self, event: dict):
        event.update(pid=os.getpid(), tid=threading.get_ident() & 0xFFFF)
        with self._lock:
            self._events.append(event)

    def write(self, path: str):
        with self._lock:
            events = list(self._events)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": self._base_ns}, f)

    def clear(self):
        with self._lock:
            self._events.clear()


class BuildCounter:
    """Misses and exclusive host seconds of the program's builders, by name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, list] = {}      # name -> [misses, seconds]
        self._local = threading.local()

    @contextlib.contextmanager
    def timed(self, name: str):
        """Count one build of ``name``: its wall time less that of the
        builds nested in it (on this thread)."""
        stack = self._local.__dict__.setdefault("stack", [])
        stack.append(0.0)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            wall = time.perf_counter() - t0
            own = wall - stack.pop()
            if stack:
                stack[-1] += wall
            with self._lock:
                c = self._counts.setdefault(name, [0, 0.0])
                c[0] += 1
                c[1] += own

    def snapshot(self) -> dict[str, tuple[int, float]]:
        """{name: (misses, exclusive seconds)} so far."""
        with self._lock:
            return {k: (m, s) for k, (m, s) in self._counts.items()}

    def clear(self):
        with self._lock:
            self._counts.clear()


class CallCounter:
    """Calls of the full-slot entry points by how they ran, per entry point:
    ``capture`` (captured, then replayed), ``replay``, or eager by reason
    (``step_graph.EAGER``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, dict[str, int]] = {}

    def count(self, entry: str, how: str) -> None:
        with self._lock:
            c = self._counts.setdefault(entry, {})
            c[how] = c.get(how, 0) + 1

    def snapshot(self) -> dict[str, dict[str, int]]:
        """{entry point: {how: calls}} so far."""
        with self._lock:
            return {k: dict(v) for k, v in self._counts.items()}

    def clear(self):
        with self._lock:
            self._counts.clear()


def cached_build(fn):
    """``functools.lru_cache(maxsize=None)`` of ``fn`` (``cache_info`` and
    ``cache_clear`` included) whose misses ``builds`` counts under the
    builder's module path within the package and name."""
    name = fn.__module__.split(".", 1)[-1] + "." + fn.__qualname__

    @functools.wraps(fn)
    def miss(*args, **kwargs):
        with builds.timed(name):
            return fn(*args, **kwargs)

    return functools.lru_cache(maxsize=None)(miss)


# Module-level tracers mirroring the reference's l1_tracer / l2_tracer.
l1_tracer = EventTracer()
builds = BuildCounter()
graph_calls = CallCounter()
