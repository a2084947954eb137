"""Device milliseconds per step of the operations launched inside the
program's ``phy.dl.slots`` and ``phy.ul.slots`` spans: a TDD step's S air
slots assembled from its DL and special slots (the zero fill and the
special slot's cut), and its UL slots and PRACH windows taken out of them.
From the stage capture (``phybench/stages.py``).  It also prints the
program's ``air_slots`` counter (air slots by entry point and kind) on
standard error, where the measured package has one."""

import sys

from phybench import stages

UNIT = "ms"
LAYER = "TDD slot assembly"
MOVES = "x_real_time"


def read(r):
    st = stages.of(r)
    if st is None:
        return None
    from srsran_edgeric_5g_tpu_torch.utils import tracing

    counter = getattr(tracing, "air_slots", None)
    if counter is not None:
        print(f"# air_slots (entry point: kind: slots, whole run): {counter.snapshot()}",
              file=sys.stderr)
    return st.device_ms("phy.dl.slots", "phy.ul.slots")
