"""The readings that the check's limits are set from, for one cell, in one
process on the card:

    python3 -m phybench.calibrate --workload <cell> --seeds 1 2 ... --control-seeds 1 2 3

For each seed: the cell's inputs at its own size, the measured package's
chained step run a few times (the last step on the HARQ carry, as in the
window), and the numbers of ``check.compare`` against the reference (the
lower reading is the largest over the seeds).  For each control seed: the
reference in bfloat16 (``reference/control.py``) put in the program's
place, compared the same way (the upper reading is the smallest).  One
JSON line per reading on standard output.  It measures nothing and the
benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

STEPS = 3   # the last one on the HARQ carry of the one before, as in the window


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m phybench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)

    from .run import set_cache_env
    set_cache_env()
    import torch

    from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm

    from . import check
    from .chain import Chain, draw_inputs
    from .spec import load_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    cfg, tr = cell.config, cell.traffic
    s = int(tr["slots"])
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            x = draw_inputs(cfg, s, float(tr["snr_db"]), seed, dev)
            if kind == "program":
                ch = Chain(fcm, cfg, x, s, dev)
                for _ in range(STEPS):
                    ch()
                td, res, flip, fail = ch.td, ch.res, ch.last_flip(), int(ch.bad)
                del ch
            else:
                flip = 1.0
                td, res = check.reference_step(cfg, x, s, flip, dev, lower=True)
                fail = int((~res["tb_ok"] | (res["payload"] != x["pay_u"]).any(-1)).sum())
            ref_td, ref_res = check.reference_step(cfg, x, s, flip, dev)
            nums = check.compare(td, res, ref_td, ref_res, fail)
            nums["ref_tb_fail"] = int((~ref_res["tb_ok"]
                                       | (ref_res["payload"] != x["pay_u"]).any(-1)).sum())
            nums["ref_sweeps_mean"] = float(ref_res["sweeps"].float().mean())
            print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed, "slots": s,
                              **nums, "seconds": time.perf_counter() - t0}), flush=True)
            del x, td, res, ref_td, ref_res
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
