"""The decode roofline's counts, and the reference decoder's sweeps, on a
tiny BG1 case."""

import torch

from phybench.reference.ops.ldpc import decoder, encoder
from phybench.reference.ops.ldpc.graph import get_graph
from phybench.roofline import ldpc_layered as rl


def test_counts_follow_the_base_graph():
    for bg in (1, 2):
        g = get_graph(bg, 8)
        assert rl.EDGES[bg] == len(g.edge_row)
        assert (rl.COLS[bg], rl.KB[bg]) == (g.cols, g.kb)
    assert rl.ops(1, 2, 3) == 16 * 316 * 2 * 3
    assert rl.bytes_moved(1, 2, 5) == 5 * (68 * 2 + 22 * 2 + 1)
    # Compute bound at many sweeps, memory bound at none.
    assert rl.bound_s(1, 224, 2048 * 6, 2048) == rl.ops(1, 224, 2048 * 6) / rl.PEAK_OPS
    assert rl.bound_s(1, 224, 0, 2048) == rl.bytes_moved(1, 224, 2048) / rl.PEAK_BYTES


def _codewords(n, zc, seed):
    g = get_graph(1, zc)
    gen = torch.Generator().manual_seed(seed)
    msg = torch.randint(0, 2, (n, g.kb * zc), generator=gen, dtype=torch.int8)
    return msg, encoder.encode(msg, 1, zc)


def test_sweeps_are_those_each_codeblock_needs():
    zc = 8
    msg, cw = _codewords(4, zc, 1)
    llr = (1 - 2 * cw.float()) * 20.0
    llr[:, :2 * zc] = 0.0                            # punctured columns
    hard, ok, sweeps = decoder.decode(llr, 1, zc, num_iters=4, early_stop=False)
    assert ok.all() and torch.equal(hard, msg)
    assert sweeps.tolist() == [1, 1, 1, 1]
    # Weak, partly wrong LLRs on one codeblock: it needs more sweeps, the
    # others still one; none is counted beyond num_iters.
    llr2 = llr.clone()
    llr2[0, 2 * zc:] = torch.where(torch.arange(llr2.shape[1] - 2 * zc) % 7 == 0,
                                   -llr2[0, 2 * zc:] / 10, llr2[0, 2 * zc:] / 10)
    _, ok2, sweeps2 = decoder.decode(llr2, 1, zc, num_iters=6, early_stop=True)
    assert sweeps2[1:].tolist() == [1, 1, 1]
    assert 1 <= int(sweeps2[0]) <= 6
