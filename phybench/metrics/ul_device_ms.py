"""Device milliseconds per step of the operations launched under the
harness's ``gnb_ul`` range, the UL slot batch call."""

UNIT = "ms"
LAYER = "parallel.full_cell.gnb_ul_slot_batch"
MOVES = "x_real_time"


def read(r):
    t = r.trace
    if r.loop != "batch" or t is None:
        return None
    s = t.device_s(lambda o: o.label == "gnb_ul")
    return 1e3 * s / t.steps if s > 0 else None
