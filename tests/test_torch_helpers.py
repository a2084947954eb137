"""Parity of the port's host helpers with the JAX package's: the bitwise
CRC oracle, the LDPC parity oracle, the polar encoder oracle, the host
GF(2) product and the Gray PAM levels.  All are numpy on both sides, so
every result is exactly equal; each oracle is also held to the port's
device code on the same inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srsran_edgeric_5g_tpu.ops import crc as jcrc, equalizer as jequ, modulation as jmod
from srsran_edgeric_5g_tpu.ops.ldpc import encoder as jenc
from srsran_edgeric_5g_tpu.ops.polar import code as jcode, encoder as jpenc
from srsran_edgeric_5g_tpu.ran import numerology as jnum
from srsran_edgeric_5g_tpu.utils import bits as jbits
from srsran_edgeric_5g_tpu_torch.ops import crc as tcrc, equalizer as tequ, modulation as tmod
from srsran_edgeric_5g_tpu_torch.ops.ldpc import encoder as tenc
from srsran_edgeric_5g_tpu_torch.ops.polar import code as tcode, encoder as tpenc
from srsran_edgeric_5g_tpu_torch.ran import numerology as tnum
from srsran_edgeric_5g_tpu_torch.utils import bits as tbits


@pytest.mark.parametrize("name,n", [("crc24a", 100), ("crc24b", 37),
                                    ("crc24c", 64), ("crc16", 51),
                                    ("crc11", 20), ("crc6", 12)])
def test_np_crc(name, n):
    bits = np.random.default_rng(n).integers(0, 2, (3, n), dtype=np.int8)
    for row in bits:
        got = tcrc.np_crc(row, name)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jcrc.np_crc(row, name))
    np.testing.assert_array_equal(
        tcrc.crc(torch.as_tensor(bits), name).numpy(),
        np.stack([tcrc.np_crc(row, name) for row in bits]))


@pytest.mark.parametrize("bg,zc", [(1, 16), (2, 40), (1, 224)])
def test_np_check_parity(bg, zc):
    """Zero on encoded codewords, the reference's syndrome on a corrupted
    one."""
    k = (22 if bg == 1 else 10) * zc
    msg = np.random.default_rng(zc).integers(0, 2, (3, k), dtype=np.int8)
    cw = tenc.encode(torch.as_tensor(msg), bg, zc).numpy().astype(np.int64)
    assert not tenc.np_check_parity(cw, bg, zc).any()
    cw[1, 5 * zc + 3] ^= 1
    got = tenc.np_check_parity(cw, bg, zc)
    np.testing.assert_array_equal(got, jenc.np_check_parity(cw, bg, zc))
    assert got[1].any() and not got[0].any()


@pytest.mark.parametrize("k,e,i_il", [(24, 60, False), (31, 100, True),
                                      (40, 100, True)])
def test_np_encode(k, e, i_il):
    msgs = np.random.default_rng(k).integers(0, 2, (4, k), dtype=np.int8)
    want = jpenc.np_encode(msgs, jcode.construct(k, e, i_il=i_il))
    code = tcode.construct(k, e, i_il=i_il)
    got = tpenc.np_encode(msgs, code)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tpenc.encode(torch.as_tensor(msgs), code).numpy(), got)


def test_np_parity_dot():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (7, 33), dtype=np.int8)
    mat = rng.integers(0, 2, (33, 12), dtype=np.int8)
    got = tbits.np_parity_dot(bits, mat)
    np.testing.assert_array_equal(got, jbits.np_parity_dot(bits, mat))
    np.testing.assert_array_equal(
        tbits.parity_dot(torch.as_tensor(bits), torch.as_tensor(mat)).numpy(), got)


@pytest.mark.parametrize("m", range(5))
def test_pam_levels(m):
    """Equal to the reference's; the mapper's per-axis amplitudes."""
    got = tmod.pam_levels(m)
    np.testing.assert_array_equal(got, jmod.pam_levels(m))
    if m:
        idx = np.arange(1 << m)
        bits = ((idx[:, None] >> np.arange(m - 1, -1, -1)) & 1).astype(np.int8)
        qam = np.stack([bits, bits], axis=-1).reshape(len(idx), 2 * m)
        sym = tmod.modulate(torch.as_tensor(qam), tmod.NAME_BY_QM[2 * m]).numpy()
        np.testing.assert_allclose(sym[:, 0].real, got, rtol=1e-6)


@pytest.mark.parametrize("name", ["NAME_BY_QM", "NRE", "INFINITY"])
def test_public_constants(name):
    """modulation.NAME_BY_QM, numerology.NRE and equalizer.INFINITY (float32
    infinity) equal the reference's."""
    if name == "NAME_BY_QM":
        assert tmod.NAME_BY_QM == jmod.NAME_BY_QM
        assert all(tmod.QM[tmod.NAME_BY_QM[qm]] == qm for qm in tmod.NAME_BY_QM)
    elif name == "NRE":
        assert tnum.NRE == jnum.NRE == tnum.N_SC_PER_PRB
    else:
        assert tequ.INFINITY.dtype == torch.float32
        assert jequ.INFINITY.dtype == jnp.float32
        assert float(tequ.INFINITY) == float(jequ.INFINITY) == float("inf")
