"""Device idle milliseconds per step in the gaps where the device waited on
the host: gaps whose ending operation was launched after the gap began.
From the stage capture (``phybench/stages.py``), whose profiler records no
host operator, so the host it traces runs at its own pace; the other gaps
are "queued" (the work was launched, the device had not started it)."""

from phybench import stages

UNIT = "ms"
LAYER = "device"
MOVES = "x_real_time"


def read(r):
    st = stages.of(r)
    return None if st is None or not st.ops else st.idle_ms(late_only=True)
