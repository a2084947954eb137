"""The device's idle share in a steady sub-window of the batch loop: one
minus the union of the device operations' intervals in the profiled steps
over the unprofiled wall time of as many steps run just before."""

UNIT = "%"
LAYER = "device"
MOVES = "x_real_time"


def read(r):
    t = r.trace
    if r.loop != "batch" or t is None or not t.ops or not r.unprofiled_wall_s:
        return None
    return 100.0 * (1.0 - t.busy_s() / r.unprofiled_wall_s)
