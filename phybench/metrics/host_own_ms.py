"""Host milliseconds per step inside the program's ``phy.dl`` and
``phy.ul`` spans, read from its own tracer (``l1_tracer``) with no profiler
on and the device drained before each step, so that no launch waits for
room in a full queue: the program's own issue cost.  From the stage
capture (``phybench/stages.py``)."""

from phybench import stages

UNIT = "ms"
LAYER = "host issue"
MOVES = "x_real_time"


def read(r):
    st = stages.of(r)
    return None if st is None else st.host_own
