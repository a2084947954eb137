"""Device milliseconds per step of the operations launched inside the
program's ``phy.ul.front`` span or one nested in it: the PUSCH front
(DM-RS estimate, MMSE, demap, wire quantise, descramble).  From the stage
capture (``phybench/stages.py``)."""

from phybench import stages

UNIT = "ms"
LAYER = "PUSCH front (chest, MMSE, demap)"
MOVES = "x_real_time"


def read(r):
    st = stages.of(r)
    return None if st is None else st.device_ms("phy.ul.front")
