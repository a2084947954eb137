"""Parity of the port's foundations with the JAX reference: numerology, TBS,
LDPC graphs, CRC, Gold sequences and bit helpers.  All bit-exact: these are
integer / GF(2) computations (float32 matmuls of 0/1 values whose sums stay
far below 2**24)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.ops import crc as jcrc
from srsran_edgeric_5g_tpu.ops import sequences as jseq
from srsran_edgeric_5g_tpu.ops.ldpc import graph as jgraph
from srsran_edgeric_5g_tpu.ran import numerology as jnum
from srsran_edgeric_5g_tpu.ran import tbs as jtbs
from srsran_edgeric_5g_tpu.utils import bits as jbits
from srsran_edgeric_5g_tpu_torch.ops import crc as tcrc
from srsran_edgeric_5g_tpu_torch.ops import sequences as tseq
from srsran_edgeric_5g_tpu_torch.ops.ldpc import graph as tgraph
from srsran_edgeric_5g_tpu_torch.ran import numerology as tnum
from srsran_edgeric_5g_tpu_torch.ran import tbs as ttbs
from srsran_edgeric_5g_tpu_torch.utils import bits as tbits

# Six test workers share the host with the JAX tests: two intra-op threads.
torch.set_num_threads(2)


@pytest.mark.parametrize("nof_prb,nfft,mu,slot,ecp", [
    (52, 768, 0, 0, False), (106, 1536, 0, 0, False), (51, 1024, 1, 1, False),
    (273, 4096, 1, 0, False), (24, 512, 2, 3, True)])
def test_slot_timing(nof_prb, nfft, mu, slot, ecp):
    a = jnum.slot_timing(nof_prb, nfft, mu, slot, ecp)
    b = tnum.slot_timing(nof_prb, nfft, mu, slot, ecp)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tnum.N_SC_PER_PRB == jnum.N_SC_PER_PRB
    assert dataclasses.asdict(tnum.cp_timing(nfft, mu)) == \
        dataclasses.asdict(jnum.cp_timing(nfft, mu))


def test_slot_timing_rejects_wide_cell():
    with pytest.raises(ValueError):
        tnum.slot_timing(106, 768)


def test_tbs_and_mcs():
    rng = np.random.default_rng(0)
    for _ in range(300):
        prb = int(rng.integers(1, 274))
        nsym = int(rng.integers(4, 15))
        ndmrs = int(rng.choice([6, 12, 18, 24]))
        nre_j = jtbs.nof_re(prb, nsym, ndmrs)
        assert ttbs.nof_re(prb, nsym, ndmrs) == nre_j
        rate = float(rng.choice([0.1, 0.2, 0.25, 0.4, 0.5, 0.67, 0.8, 0.93]))
        qm = int(rng.choice([2, 4, 6, 8]))
        layers = int(rng.integers(1, 3))
        assert ttbs.tbs(nre_j, rate, qm, layers) == jtbs.tbs(nre_j, rate, qm, layers)
    for table in ("qam64", "qam256", "qam64lowse"):
        for idx in range(32):
            try:
                want = jtbs.mcs_config(idx, table)
            except ValueError:
                with pytest.raises(ValueError):
                    ttbs.mcs_config(idx, table)
                continue
            got = ttbs.mcs_config(idx, table)
            assert (got.qm, got.target_rate, got.modulation) == \
                (want.qm, want.target_rate, want.modulation)


@pytest.mark.parametrize("bg", [1, 2])
@pytest.mark.parametrize("zc", [2, 15, 64, 128, 224, 384])
def test_graph(bg, zc):
    a, b = jgraph.get_graph(bg, zc), tgraph.get_graph(bg, zc)
    for f in ("rows", "cols", "kb", "k", "n", "n_full", "num_edges"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("edge_row", "edge_col", "edge_shift", "shifts"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.max_row_degree() == b.max_row_degree()


def test_lifting_and_gf2():
    assert tgraph.lifting_sizes() == jgraph.LIFTING_SIZES
    for kb, kp in [(22, 100), (10, 2424), (22, 8448), (6, 40), (8, 500)]:
        assert tgraph.min_lifting_size(kb, kp) == jgraph.min_lifting_size(kb, kp)
    with pytest.raises(ValueError):
        tgraph.lifting_index(17)
    g = tgraph.get_graph(2, 3)
    h = tgraph.build_parity_check_dense(g)
    np.testing.assert_array_equal(h, jgraph.build_parity_check_dense(jgraph.get_graph(2, 3)))
    rng = np.random.default_rng(1)
    a = (np.eye(12, dtype=np.uint8) + np.triu(rng.integers(0, 2, (12, 12)), 1)) % 2
    inv = tgraph.gf2_inv(a)
    np.testing.assert_array_equal(inv, jgraph.gf2_inv(a))
    np.testing.assert_array_equal((a.astype(int) @ inv) % 2, np.eye(12))


@pytest.mark.parametrize("name", sorted(jcrc.BY_NAME))
def test_crc(name):
    rng = np.random.default_rng(len(name))
    for n in (1, 13, 100, 3824):
        bits = rng.integers(0, 2, (5, n), dtype=np.int8)
        np.testing.assert_array_equal(
            tcrc.remainder_table(name, n), jcrc.remainder_table(name, n))
        att_j = np.asarray(jcrc.crc_attach(jnp.asarray(bits), name))
        att_t = tcrc.crc_attach(torch.as_tensor(bits), name).numpy()
        np.testing.assert_array_equal(att_t, att_j)
        np.testing.assert_array_equal(att_t[0, n:], jcrc.np_crc(bits[0], name))
        bad = att_t.copy()
        bad[1, int(rng.integers(0, n))] ^= 1
        np.testing.assert_array_equal(
            tcrc.crc_check(torch.as_tensor(bad), name).numpy(),
            np.asarray(jcrc.crc_check(jnp.asarray(bad), name)))
        assert not tcrc.crc_check(torch.as_tensor(bad[1:2]), name).item()


@pytest.mark.parametrize("length", [1, 31, 100, 1600, 18720])
def test_gold_and_scrambling(length):
    rng = np.random.default_rng(length)
    cinit = np.concatenate([[0, 1, 2 ** 31 - 1],
                            rng.integers(0, 2 ** 31, 5)]).astype(np.uint32)
    seq_j = np.asarray(jseq.gold_sequence(jnp.asarray(cinit), length))
    seq_t = tseq.gold_sequence(torch.as_tensor(cinit.astype(np.int64)), length)
    assert seq_t.dtype == torch.int8
    np.testing.assert_array_equal(seq_t.numpy(), seq_j)
    np.testing.assert_array_equal(seq_t[3].numpy(), jseq.np_gold_sequence(int(cinit[3]), length))
    bits = rng.integers(0, 2, (8, length), dtype=np.int8)
    np.testing.assert_array_equal(
        tseq.scramble_bits(torch.as_tensor(bits),
                           torch.as_tensor(cinit.astype(np.int64))).numpy(),
        np.asarray(jseq.scramble_bits(jnp.asarray(bits), jnp.asarray(cinit))))
    llrs = np.round(rng.normal(size=(8, length)) * 40).astype(np.float32)
    np.testing.assert_array_equal(
        tseq.scramble_llrs(torch.as_tensor(llrs),
                           torch.as_tensor(cinit.astype(np.int64))).numpy(),
        np.asarray(jseq.scramble_llrs(jnp.asarray(llrs), jnp.asarray(cinit))))


@pytest.mark.parametrize("order", ["msb", "lsb"])
def test_bits(order):
    rng = np.random.default_rng(7)
    packed = rng.integers(0, 256, (3, 11), dtype=np.uint8)
    un_j = np.asarray(jbits.unpack_bits(jnp.asarray(packed), order))
    un_t = tbits.unpack_bits(torch.as_tensor(packed), order)
    np.testing.assert_array_equal(un_t.numpy(), un_j)
    np.testing.assert_array_equal(
        tbits.pack_bits(un_t, order).numpy(),
        np.asarray(jbits.pack_bits(jnp.asarray(un_j), order)))
    np.testing.assert_array_equal(tbits.pack_bits(un_t, order).numpy(), packed)
    with pytest.raises(ValueError):
        tbits.pack_bits(un_t[:, :-1], order)


def test_parity_dot():
    rng = np.random.default_rng(8)
    b = rng.integers(0, 2, (4, 2000), dtype=np.int8)
    m = rng.integers(0, 2, (2000, 33), dtype=np.int8)
    np.testing.assert_array_equal(
        tbits.parity_dot(torch.as_tensor(b), torch.as_tensor(m)).numpy(),
        np.asarray(jbits.parity_dot(jnp.asarray(b), jnp.asarray(m))))
    np.testing.assert_array_equal(
        tbits.parity_dot(torch.as_tensor(b), torch.as_tensor(m)).numpy(),
        jbits.np_parity_dot(b, m))
