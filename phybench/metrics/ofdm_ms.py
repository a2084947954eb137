"""Device milliseconds per step of the operations launched inside the
program's ``phy.dl.ofdm`` and ``phy.ul.ofdm`` spans or one nested in
them: OFDM (the DL modulation with the TX amplitude, the UL
demodulation).  From the stage capture (``phybench/stages.py``)."""

from phybench import stages

UNIT = "ms"
LAYER = "OFDM mod / demod"
MOVES = "x_real_time"


def read(r):
    st = stages.of(r)
    return None if st is None else st.device_ms("phy.dl.ofdm", "phy.ul.ofdm")
