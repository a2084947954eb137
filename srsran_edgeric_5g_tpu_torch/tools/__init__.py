"""Validation entry points of the port: the counterparts of the JAX
package's ``tools/`` that produce the repository's evidence that its chain
decodes the way srsRAN's does.

Each module runs as ``python -m srsran_edgeric_5g_tpu_torch.tools.<name>``
with the JAX tool's flags, plus ``--device`` (``cuda`` by default; ``cpu``
runs the plain versions of the kernels) and ``--out PATH``, which has no
default, so a run never overwrites a committed record:

  * ``bler_sweep``          BLER waterfalls of the coded chain (``BLER_R1.md``);
  * ``bler_parity``         the decode schedules on identical int8 buffers;
  * ``bler_channel_sweep``  the PUSCH receive chain through the channel
                            profiles and the RLF run (``BLER_CHANNELS_R4.md``);
  * ``chest_bler_ab``       BLER through both channel estimators
                            (``CHEST_BLER_R2.md``);
  * ``sched_churn``         grant layouts of the PF scheduler and what a
                            layout's first use costs;
  * ``kernel_bench``        per-stage throughput.

The helpers here are shared by the receive-chain tools.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def parser(prog: str, doc: str) -> argparse.ArgumentParser:
    """An argument parser with the two flags every tool takes."""
    ap = argparse.ArgumentParser(prog=f"python -m {prog}",
                                 description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--out", default=None,
                    help="write the markdown record here (nothing is written "
                         "without it)")
    return ap


def write_record(path: str | None, lines: list[str]) -> None:
    if path is None:
        return
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {path}", flush=True)


def k1_launches() -> int:
    """K1's launch count so far (``cuda_build.LAUNCHES``)."""
    from .. import cuda_build
    from ..ops.ldpc import decoder_cuda
    return cuda_build.LAUNCHES[decoder_cuda.KERNEL]


def receive(grids: torch.Tensor, cfg, srate: float, symbol_times: np.ndarray,
            delay_spread_s: float | None = None, num_iters: int = 6):
    """``pusch.process`` over (B, nsymb, nsubc) received grids: each grid's
    front (channel estimate, equalise, demap, dematch), then one decode of
    the stacked codeblocks, each TB's stopping on its own as under the
    reference's ``vmap`` of one slot's receive (``exit_group`` C) -> (payload
    (B, TBS), tb_ok (B,), the (B*C, cols*Zc) decoder input)."""
    from ..models import pdsch, pusch
    from ..ops.ldpc import decoder, segmenter
    seg, rms = pdsch._plans(cfg, 0)
    fulls = []
    for g in grids:
        h, nv, cfo = pusch.channel_estimate(g, cfg, srate, symbol_times,
                                            delay_spread_s=delay_spread_s)
        x_hat, nv_out = pusch.equalize(g, cfg, h, nv, cfo, symbol_times)
        fulls.append(pusch.dematch(pusch.demap(x_hat, nv_out, cfg), seg, rms))
    llrs = torch.cat(fulls, dim=0)
    hard, _ = decoder.decode(llrs, seg.bg, seg.zc, num_iters=num_iters,
                             schedule="wire_auto", exit_group=seg.c)
    payload, tb_ok = segmenter.desegment_tb(hard, seg)
    return payload, tb_ok, llrs
