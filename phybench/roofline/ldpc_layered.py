"""The least time a layered min-sum LDPC decode of a batch could take on
one NVIDIA H100, whatever implements it.

Work.  A layered sweep visits every edge of the base graph once per lane
of the lifting size Zc.  Per edge and lane: the extrinsic t = L - R (1),
its magnitude and sign (2), the running first and second minimum and the
argmin (4), the sign product (1), the scaled magnitude (1), the selection
of m1 or m2 (1), the signed message (1), the posterior L' = t + R' (1),
the message and posterior stores (2), and the parity of the hard bit (2):
16 operations.  The sweeps are those these inputs need: per codeblock the
first sweep after which its own syndrome is zero (the reference decoder's
count, ``num_iters`` where it never is), summed over the codeblocks.  A
decoder that sweeps a codeblock longer (a batch-wide exit) does more work
than counted, and its share shows it.

Bytes.  The int8 decoder input of cols x Zc LLRs per codeblock read once,
the int8 hard bits of kb x Zc and one parity flag per codeblock written
once.

Peaks (NVIDIA's H100 SXM data sheet, at the 700 W power limit):
* 67e12 operations/s: the data sheet's 67 TFLOP/s float32 outside the
  tensor cores, taken as simple operations per second.  That rate counts a
  fused multiply-add as two: 132 SMs x 128 float32 lanes x 1.98 GHz x 2.
  One instruction per lane and clock is half of it (33.5e12), and Hopper's
  int32 pipe half of that again, so against 67e12 the share is a lower
  bound of the share against any issue rate the decode could reach.
* 3.35e12 bytes/s: the HBM3 bandwidth.
"""

from __future__ import annotations

OPS_PER_EDGE_LANE = 16
# Nonzero entries of the base graphs, TS 38.212 Tables 5.3.2-2 and -3.
EDGES = {1: 316, 2: 197}
COLS = {1: 68, 2: 52}
KB = {1: 22, 2: 10}
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12


def ops(bg: int, zc: int, sweeps_total: int) -> int:
    """Operations of ``sweeps_total`` codeblock-sweeps at (bg, zc)."""
    return OPS_PER_EDGE_LANE * EDGES[bg] * zc * sweeps_total


def bytes_moved(bg: int, zc: int, n_cb: int) -> int:
    """Bytes in and out of a decode of ``n_cb`` codeblocks."""
    return n_cb * (COLS[bg] * zc + KB[bg] * zc + 1)


def bound_s(bg: int, zc: int, sweeps_total: int, n_cb: int) -> float:
    """The larger of the compute and the memory time."""
    return max(ops(bg, zc, sweeps_total) / PEAK_OPS,
               bytes_moved(bg, zc, n_cb) / PEAK_BYTES)
