"""EdgeRIC muApp layer: RIC-side messenger + per-TTI scheduling policies.

Port of ``srsran_edgeric_5g_tpu/ric``: the messenger, the muApp policies,
the monitor, the algorithm switch, and the RL and NeurWIN policies with
their training loops (``rl.ppo_train`` on the ``rl.EdgeRicSimEnv`` twin,
``neurwin.neurwin_train`` on ``neurwin.ArmEnv``).  pyzmq and protobuf are imported when a
``RicMessenger`` is built, not before.
"""

from .messenger import RicMessenger  # noqa: F401
from .muapp import (  # noqa: F401
    MuAppScheduler,
    fixed_weights,
    max_cqi_weights,
    max_weight_weights,
    prop_fair_weights,
    round_robin_weights,
)
from .monitor import ThroughputMonitor  # noqa: F401
from .switchboard import AlgorithmSwitch  # noqa: F401
