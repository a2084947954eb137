"""Failure detection and radio event handling.

Copy of ``srsran_edgeric_5g_tpu/runtime/events.py`` (plain Python), the
counterpart of the reference's resilience mechanisms:

  * late-request detection in the lower PHY
    (puxch_processor_impl.cpp:48-60 `on_puxch_request_late`): a slot whose
    processing misses its real-time budget, or a request for a slot that
    has already passed, raises a LATE event instead of an error;
  * the radio event notifier (ru_radio_notifier_handler.h): UNDERFLOW /
    OVERFLOW / LATE counters fed by the sample transport;
  * skipped-slot handling in the scheduler (cell_scheduler.cpp:99-108):
    on a forward slot jump the reference counts the gap and fast-forwards
    its internal state rather than processing stale slots;
  * the upper-PHY error handler (upper_phy_error_handler_impl.cpp) and the
    EdgeRIC fail-open rule (edgeric.cpp:289-295): per-slot processing
    failures are counted and the pipeline continues with a fallback result
    instead of crashing the slot loop.

Everything here is host-side bookkeeping around the slot programs — no
device work — so it mirrors the reference's thread-side FSMs without
touching the pipeline.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class RadioEvents:
    """Counter block of the radio/PHY event notifier."""

    late: int = 0
    underflow: int = 0
    overflow: int = 0
    skipped_slots: int = 0
    errors: int = 0

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)

    def total(self) -> int:
        return self.late + self.underflow + self.overflow \
            + self.skipped_slots + self.errors


class RadioEventNotifier:
    """ru_radio_notifier_handler-style sink: count + optional log callback.

    The reference prints one line per radio event (underflow "U", overflow
    "O", late "L"); ``log`` receives the same terse notifications.
    """

    def __init__(self, log: Callable[[str], None] | None = None):
        self.events = RadioEvents()
        self._log = log if log is not None else (lambda s: None)

    def on_late(self, slot: int) -> None:
        self.events.late += 1
        self._log(f"L slot={slot}")

    def on_underflow(self, slot: int) -> None:
        self.events.underflow += 1
        self._log(f"U slot={slot}")

    def on_overflow(self, slot: int) -> None:
        self.events.overflow += 1
        self._log(f"O slot={slot}")

    def on_skipped(self, slot: int) -> None:
        self.events.skipped_slots += 1
        self._log(f"skip slot={slot}")

    def on_error(self, slot: int, err: BaseException) -> None:
        self.events.errors += 1
        self._log(f"E slot={slot}: {err!r}")


class SlotClock:
    """Skipped-slot / stale-slot tracking (cell_scheduler.cpp:99-108).

    ``advance(slot)`` returns the list of slots skipped since the last call
    (counted as SKIPPED events, like the reference's gap fast-forward) and
    flags a request for an already-passed slot as LATE, returning None so
    the caller drops it (puxch late-request semantics).
    """

    def __init__(self, notifier: RadioEventNotifier):
        self._notifier = notifier
        self._next: int | None = None

    def advance(self, slot: int) -> list[int] | None:
        if self._next is None:
            self._next = slot + 1
            return []
        if slot < self._next:
            self._notifier.on_late(slot)
            return None
        skipped = list(range(self._next, slot))
        for s in skipped:
            self._notifier.on_skipped(s)
        self._next = slot + 1
        return skipped


class SlotDeadline:
    """Real-time budget check — the ``nof_slot_tti_in_advance`` analogue
    (downlink_processor_baseband_impl.cpp:47): a slot whose processing
    takes longer than ``run_ahead`` slot durations has missed the radio
    clock and is reported LATE.
    """

    def __init__(self, slot_duration_s: float, run_ahead: int,
                 notifier: RadioEventNotifier,
                 clock: Callable[[], float] = time.monotonic):
        self.budget_s = slot_duration_s * run_ahead
        self._notifier = notifier
        self._clock = clock

    def start(self) -> float:
        return self._clock()

    def finish(self, slot: int, token: float) -> bool:
        """Returns True when the slot met its budget."""
        ok = (self._clock() - token) <= self.budget_s
        if not ok:
            self._notifier.on_late(slot)
        return ok


def fail_open(notifier: RadioEventNotifier, slot: int,
              fn: Callable, *args, fallback=None):
    """upper_phy_error_handler_impl / EdgeRIC fail-open semantics: a failing
    slot handler is counted as an ERROR and the loop continues with
    ``fallback`` instead of propagating (the reference logs and keeps the
    cell alive; EdgeRIC clears the policy maps and falls back to the
    default scheduler, edgeric.cpp:289-295)."""
    try:
        return fn(*args)
    except Exception as err:  # noqa: BLE001 — the point is to contain it
        notifier.on_error(slot, err)
        return fallback
