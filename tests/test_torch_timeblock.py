"""The port's time-block stream (``parallel/timeblock.py``) with 8 CPU
blocks against the JAX package's 8-device CPU mesh, on the same seeded
grids at the 10 MHz cell of tests/test_timeblock.py.

Samples and grids agree within 1e-4 of the reference's (torch.fft and
XLA's FFT sum in different orders; float32); against the transmitted grids
the tolerances are tests/test_timeblock.py's (atol 3e-4 with a shift).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu.ops import ofdm as jofdm
from srsran_edgeric_5g_tpu.parallel import timeblock as jtb
from srsran_edgeric_5g_tpu.ran import numerology as jnum
from srsran_edgeric_5g_tpu_torch.ops import ofdm as tofdm
from srsran_edgeric_5g_tpu_torch.parallel import timeblock as ttb
from srsran_edgeric_5g_tpu_torch.ran import numerology as tnum

torch.set_num_threads(2)
S = 16
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def stream():
    jt = jnum.slot_timing(**jnum.CELL_10MHZ)
    tt = tnum.slot_timing(**tnum.CELL_10MHZ)
    rng = np.random.default_rng(5)
    shape = (S, jt.nsymb, jt.nof_subc)
    grids = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    mesh = jtb.make_time_mesh(8)
    td_j = np.asarray(jax.jit(lambda g: jtb.modulate_stream_sharded(g, jt, mesh))(
        jnp.asarray(grids)))
    demod = {shift: np.asarray(jax.jit(lambda x, s=shift: jtb.demodulate_stream_sharded(
        x, jt, mesh, shift=s))(jnp.asarray(td_j))) for shift in (0, 16)}
    return dict(jt=jt, tt=tt, grids=grids, td_j=td_j, demod=demod)


def test_make_time_mesh():
    assert ttb.make_time_mesh(3, CPU8) == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ttb.make_time_mesh()


def test_modulate_matches_reference(stream):
    td_t = ttb.modulate_stream_sharded(stream["grids"], stream["tt"],
                                       ttb.make_time_mesh(8, CPU8))
    assert td_t.shape == stream["td_j"].shape and td_t.dtype == torch.complex64
    np.testing.assert_allclose(td_t.numpy(), stream["td_j"], atol=1e-4)
    np.testing.assert_allclose(td_t.numpy(), tofdm.modulate_slot(
        torch.as_tensor(stream["grids"]), stream["tt"]).numpy(), atol=1e-4)


@pytest.mark.parametrize("shift", [0, 16])
def test_demodulate_matches_reference(stream, shift):
    back = ttb.demodulate_stream_sharded(torch.as_tensor(stream["td_j"]), stream["tt"],
                                         CPU8, shift=shift).numpy()
    np.testing.assert_allclose(back, stream["demod"][shift], atol=1e-4)
    grids = stream["grids"]
    # An early window inside the CP is transparent after the phase ramp.
    np.testing.assert_allclose(back[1:], grids[1:], atol=3e-4)
    np.testing.assert_allclose(back[0, 1:], grids[0, 1:], atol=3e-4)


def test_halo_crosses_blocks(stream):
    """One slot per block, so every slot boundary is a block boundary: the
    8-block result is the one-block result slot for slot, and the
    reference's on the same samples (tests/test_timeblock.py's halo test)."""
    td = torch.as_tensor(stream["td_j"][:8])
    with_halo = ttb.demodulate_stream_sharded(td, stream["tt"], CPU8, shift=16)
    one_block = ttb.demodulate_stream_sharded(td, stream["tt"], ["cpu"], shift=16)
    np.testing.assert_allclose(with_halo.numpy(), one_block.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(with_halo[1:].numpy(), stream["grids"][1:8], atol=3e-4)
    np.testing.assert_allclose(with_halo.numpy(), stream["demod"][16][:8], atol=1e-4)
    with pytest.raises(ValueError):
        ttb.demodulate_stream_sharded(td, stream["tt"], CPU8,
                                      shift=min(stream["tt"].cp.cp) + 1)
