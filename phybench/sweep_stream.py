"""The sweep that fixed the stream cell's S: the full gNB slot streamed in a
closed loop, each batch of S slots submitted as soon as one of ``depth``
in flight completes, at each S given; the sustained multiple of real time
(slots completed times the slot duration over the wall time) of each run.

    python3 -m phybench.sweep_stream --sizes 16 32 --runs 3

The stream cell takes the smallest S whose every run sustains 1.25x real
time or more, so that the air rate it offers is at most four fifths of
the rate the system sustains.  One JSON line per run.  On the card only.
"""

from __future__ import annotations

import argparse
import json
import sys

CONFIG, TRAFFIC = "nr20_siso_4ue", "stream_air_rate"
BATCHES = 300
SEED = 20260


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m phybench.sweep_stream")
    p.add_argument("--sizes", type=int, nargs="+", default=[16, 32])
    p.add_argument("--runs", type=int, default=3)
    args = p.parse_args(argv)

    from .run import set_cache_env
    set_cache_env()
    import torch

    from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm

    from . import loops
    from .chain import Chain, draw_inputs
    from .spec import HERE, load_traffic

    if not torch.cuda.is_available():
        print("sweep_stream: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    with open(HERE / "configs" / f"{CONFIG}.json") as f:
        cfg = json.load(f)
    tr = load_traffic(TRAFFIC)
    slot_s = 1e-3 / (1 << int(cfg.get("mu", 0)))
    for s in args.sizes:
        x = draw_inputs(cfg, s, float(tr["snr_db"]), SEED, dev)
        ch = Chain(fcm, cfg, x, s, dev)
        marks = loops.CudaMarks()

        def submit(b):
            ch()
            return marks.mark()

        for _ in range(int(tr["warmup_steps"])):
            ch()
        torch.cuda.synchronize(dev)
        for r in range(args.runs):
            wall = loops.closed_stream(submit, marks, BATCHES, int(tr["depth"]))
            torch.cuda.synchronize(dev)
            print(json.dumps({"slots": s, "run": r, "batches": BATCHES, "wall_s": wall,
                              "x_real_time": BATCHES * s * slot_s / wall,
                              "failed_tbs": int(ch.bad)}), flush=True)
        del ch, x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
