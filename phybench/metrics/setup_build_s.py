"""Host seconds of the program's table builds in the run's set-up: the
exclusive seconds of every miss of its cached builders, from its build
counter (``utils.tracing.builds``), read before anything else of the traced
run's per-layer metrics builds (``phybench/stages.py``).  nvcc's seconds
(``nvcc.<kernel>``) are left out: they come only in a checkout's first
run, and standard error lists them apart.
"""

from phybench import stages

UNIT = "s"
LAYER = "set-up"
MOVES = "setup_s"


def read(r):
    b = stages.setup_builds(r)
    return None if b is None else stages.build_s(b)
