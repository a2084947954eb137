"""Device operations (kernels, copies, memsets) per step in the profiled
sub-window: what the host has to launch for one step."""

UNIT = "ops"
LAYER = "host issue"
MOVES = "x_real_time"


def read(r):
    t = r.trace
    if r.loop != "batch" or t is None or not t.ops:
        return None
    return len(t.ops) / t.steps
