"""The device's idle share over a few periods of the open loop: one minus
the union of the device operations' intervals over the wall time of those
periods (the schedule, not the system, sets that wall)."""

UNIT = "%"
LAYER = "device"
MOVES = "latency_p95_ms"


def read(r):
    t = r.trace
    if r.loop != "stream" or t is None or not t.ops or t.wall_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.wall_s)
