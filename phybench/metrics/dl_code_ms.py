"""Device milliseconds per step of the operations launched inside the
program's ``phy.dl.code`` span or one nested in it: PDSCH coding
(segment, CRC, LDPC encode, rate match, scramble, QAM map). From the
stage capture (``phybench/stages.py``)."""

from phybench import stages

UNIT = "ms"
LAYER = "PDSCH coding"
MOVES = "x_real_time"


def read(r):
    st = stages.of(r)
    return None if st is None else st.device_ms("phy.dl.code")
