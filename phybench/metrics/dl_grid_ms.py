"""Device milliseconds per step of the operations launched inside the
program's ``phy.dl.grid`` span or one nested in it: the DL resource
grids (PDSCH and DM-RS placement, control rows, the SSB sub-batch's
merge, the MIMO layer mapping).  From the stage capture
(``phybench/stages.py``)."""

from phybench import stages

UNIT = "ms"
LAYER = "DL resource grids"
MOVES = "x_real_time"


def read(r):
    st = stages.of(r)
    return None if st is None else st.device_ms("phy.dl.grid")
