"""Device milliseconds per step of the operations launched inside the
program's ``phy.ul.decode`` span or one nested in it: the UL decode (K1,
its resume rounds and their glue) and the TB CRC. From the stage capture
(``phybench/stages.py``)."""

from phybench import stages

UNIT = "ms"
LAYER = "ops.ldpc UL decode"
MOVES = "x_real_time"


def read(r):
    st = stages.of(r)
    return None if st is None else st.device_ms("phy.ul.decode")
