"""The UL decode's share of its roofline: the least time the decode of a
step's codeblocks could take (``roofline/ldpc_layered.py``, from the
shapes and the sweeps these inputs need) over the device time per step of
the decode kernels.  The kernels are those whose trace names match a
pattern in a file of ``decode_roofline/``; a change that brings another
decode kernel adds a file there."""

import pathlib
import re

UNIT = "%"
LAYER = "ops.ldpc UL decode"
MOVES = "x_real_time"

PATTERNS = [re.compile(line.strip())
            for f in sorted((pathlib.Path(__file__).parent / "decode_roofline").glob("*.txt"))
            for line in f.read_text().splitlines()
            if line.strip() and not line.startswith("#")]


def read(r):
    t = r.trace
    if r.loop != "batch" or t is None or not r.decode_bound_s:
        return None
    s = t.device_s(lambda o: any(p.search(o.name) for p in PATTERNS))
    if s <= 0:
        return None
    return 100.0 * r.decode_bound_s * t.steps / s
