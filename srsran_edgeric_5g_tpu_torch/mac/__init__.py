"""MAC layer: per-slot scheduler with EdgeRIC real-time policy hooks.

Port of ``srsran_edgeric_5g_tpu/mac`` (plain Python, copied so that the
port never imports the JAX package).
"""

from .scheduler import (  # noqa: F401
    CellScheduler,
    DlGrant,
    SchedulerConfig,
    SchedUe,
    mcs_from_cqi,
    prbs_for_bytes,
)
