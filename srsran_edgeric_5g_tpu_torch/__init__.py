"""PyTorch/CUDA port of the 5G gNB PHY signal chain in ``srsran_edgeric_5g_tpu``.

The JAX package beside this one is the reference: every module here mirrors
its counterpart there (``ran/``, ``ops/``, ``ops/ldpc/``, ``parallel/``) and
is held to it by the ``tests/test_torch_*.py`` parity tests.  This package
imports ``torch`` and numpy only, never ``jax`` and nothing of the JAX
package; the spec tables it needs live in its own ``data/``.

Plain tensor code is PyTorch.  The TPU kernel on the hot path (the layered
min-sum LDPC decoder, a Pallas kernel in the reference) is a hand-written
CUDA kernel in ``csrc/``, built with nvcc at first use (see ``cuda_build``).

Public entry points take ``device="cuda"`` by default and raise on a host
without a CUDA device; pass ``device="cpu"`` to run the plain versions.
"""

import torch

# The GF(2) products (CRC, Gold sequences, LDPC encoding) are float32 matmuls
# of 0/1 values whose integer sums must stay exact, and the symbol stages are
# held to the JAX reference at ~1e-5.  TF32 keeps ~3 decimal digits, so both
# matmul and cuDNN TF32 are off for the whole package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
