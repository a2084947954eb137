"""Device milliseconds per step of the operations launched under the
harness's ``gnb_dl`` range, the DL slot batch call."""

UNIT = "ms"
LAYER = "parallel.full_cell.gnb_dl_slot_batch"
MOVES = "x_real_time"


def read(r):
    t = r.trace
    if r.loop != "batch" or t is None:
        return None
    s = t.device_s(lambda o: o.label == "gnb_dl")
    return 1e3 * s / t.steps if s > 0 else None
