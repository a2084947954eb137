"""Chrome trace-event tracing for the slot pipeline.

Copy of ``srsran_edgeric_5g_tpu/utils/tracing.py`` (plain Python).
Counterpart of the reference's file_event_tracer / l1_tracer
(srsRAN-5G-ER/lib/instrumentation/, usage e.g. uplink_processor_impl.cpp:83)
which writes Chrome trace-event JSON.  The tracer wraps host-side stage
boundaries (device work is profiled separately with torch.profiler); the
output loads in chrome://tracing / Perfetto like the reference's traces.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time


class EventTracer:
    """Collects complete ('X') trace events; disabled unless started."""

    def __init__(self):
        self._events: list[dict] = []
        self._enabled = False
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def enable(self):
        self._enabled = True
        self._t0 = time.perf_counter()

    def disable(self):
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    @contextlib.contextmanager
    def span(self, name: str, **args):
        if not self._enabled:
            yield
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            with self._lock:
                self._events.append({
                    "name": name,
                    "ph": "X",
                    "ts": (start - self._t0) * 1e6,
                    "dur": (end - start) * 1e6,
                    "pid": os.getpid(),
                    "tid": threading.get_ident() & 0xFFFF,
                    "args": args,
                })

    def instant(self, name: str, **args):
        if not self._enabled:
            return
        with self._lock:
            self._events.append({
                "name": name, "ph": "i", "s": "t",
                "ts": (time.perf_counter() - self._t0) * 1e6,
                "pid": os.getpid(), "tid": threading.get_ident() & 0xFFFF,
                "args": args,
            })

    def write(self, path: str):
        with self._lock:
            events = list(self._events)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)

    def clear(self):
        with self._lock:
            self._events.clear()


# Module-level tracers mirroring the reference's l1_tracer / l2_tracer.
l1_tracer = EventTracer()
