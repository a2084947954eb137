"""The plain reference of the full gNB slot, for the benchmark's check of
what the timed path produced.

A frozen copy of the plain PyTorch code of the measured package's full
slot (``parallel/full_cell.py``, ``parallel/slot_pipeline.py`` and the ops
and models they call), with the imports made relative to this folder, the
scale-out arguments taken out (it runs on one device) and the LDPC decode
left as the plain layered min-sum (no CUDA kernel).
It imports torch and numpy only, reads its spec tables from its own
``data/``, and never imports the measured package: a later change to that
package cannot move the yardstick.  ``lower_precision`` (``control.py``)
runs it with its signal stages rounded to bfloat16, the check's control.

``FullCellConfig`` adds a TDD slot pattern of its own, ahead of the
measured package: ``tdd_period``, ``tdd_dl_slots``, ``tdd_dl_symbols``,
``tdd_ul_slots`` and ``tdd_ul_symbols``, after srsRAN's ``tdd_ul_dl_cfg``;
period 0, the default, is paired spectrum and the reference as it was.  The
entry points keep their signatures and speak in air slots: the DL and the
UE's UL return all ``S`` slots of a step (zero where the pattern does not
send), the gNB's UL takes all ``S`` and returns results for the UL slots
alone.  The special slot carries the PDCCH and the CSI-RS on its DL
symbols and no PDSCH, a departure from srsRAN, which may schedule a
shortened PDSCH there.  A PRACH preamble longer than a slot spans
consecutive UL slots.  An occasion on a slot of the wrong kind, or a
PRACH occasion that leaves the UL slots or the step, is refused with a
``ValueError``.  ``parallel/full_cell.py`` states the rules.

``inputs.shapes`` states the random bit inputs of one step, in the order
that the harness draws them from the seed for both sides, in the shapes
that the slot pattern gives.
"""

import torch

# The GF(2) products (CRC, Gold sequences, LDPC encoding) are float32
# matmuls of 0/1 values whose integer sums must stay exact, and the
# reference is plain float32: TF32 is off for both matmul and cuDNN.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
