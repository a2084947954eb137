"""Device milliseconds per step of the operations launched inside the
program's ``phy.ul.dematch`` span or one nested in it: the rate dematch
and the HARQ combine into the int8 carry. From the stage capture
(``phybench/stages.py``)."""

from phybench import stages

UNIT = "ms"
LAYER = "dematch + HARQ combine"
MOVES = "x_real_time"


def read(r):
    st = stages.of(r)
    return None if st is None else st.device_ms("phy.ul.dematch")
