"""Device milliseconds per step of the operations launched inside the
program's ``phy.ul.control`` span or one nested in it: the UL control
channels (PUCCH F1 / F2, SRS, PRACH).  From the stage capture
(``phybench/stages.py``)."""

from phybench import stages

UNIT = "ms"
LAYER = "PUCCH F1/F2, SRS, PRACH"
MOVES = "x_real_time"


def read(r):
    st = stages.of(r)
    return None if st is None else st.device_ms("phy.ul.control")
