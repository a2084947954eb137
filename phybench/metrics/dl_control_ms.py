"""Device milliseconds per step of the operations launched inside the
program's ``phy.dl.control`` span or one nested in it: the DL control
chains (PDCCH and PBCH polar coding, the CSI-RS rows).  From the stage
capture (``phybench/stages.py``)."""

from phybench import stages

UNIT = "ms"
LAYER = "PDCCH / SSB polar chains, CSI-RS"
MOVES = "x_real_time"


def read(r):
    st = stages.of(r)
    return None if st is None else st.device_ms("phy.dl.control")
