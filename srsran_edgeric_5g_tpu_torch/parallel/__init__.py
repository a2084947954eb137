"""Slot-level pipelines and their scale-out over ranks.

On one card the UE, codeblock and cell axes are batch dimensions; with a
``DeviceMesh`` (``mesh.make_mesh`` and its siblings) the programs shard
them over ``torch.distributed`` ranks:

  axis 'ue'   — UE rows (the reference's per-UE processing)
  axis 'cb'   — codeblock rows (the reference's fork_cb_batches)

and gather what the next stage needs (the grid's symbol rows, the TB's
hard bits).
"""

from .mesh import make_mesh, UE_AXIS, CB_AXIS  # noqa: F401
