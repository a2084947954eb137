"""Process groups, device meshes and the row layouts of the sharded programs.

Port of ``srsran_edgeric_5g_tpu/parallel/mesh.py``.  The axes are the
reference's: per-cell worker pools -> 'cell', per-UE processing -> 'ue',
codeblock fork/join pools -> 'cb', and 'host' for the process boundary.
One rank of ``torch.distributed`` drives one device, so a mesh is a
``DeviceMesh`` over ranks; the "host" of a rank is ``rank //
LOCAL_WORLD_SIZE`` (torchrun sets that variable; without it every rank is
on one host).

A sharded tensor is a ``DTensor`` whose leading dim is split as a JAX
``PartitionSpec`` on that dim splits it: ``shard(x, mesh, ((UE, CB),))``
is ``Shard(0)`` on the 'ue' and the 'cb' mesh dims, nested in mesh order
(the row-major flattening JAX uses), every other mesh dim ``Replicate()``.
Blocks follow ``torch.chunk``: 10 rows over (ue 2, cb 2) are 3, 2, 3, 2
(JAX pads to 3, 3, 3, 1), and a rank's block may be empty.  The programs
compute on plain local tensors; only a change of layout moves data:
``take`` slices a rank's rows out of a global tensor (nothing moves) or
out of a DTensor, all-gathering over the sharded mesh dims the new layout
drops (innermost first, also where a dim has one rank, so that a program
makes the same collectives at every world size) and over more dims until
every rank's block holds the rows it needs.  Every all-gather is counted
per mesh axis (``COLLECTIVES``), the counterpart of the collectives that
``__graft_entry__._collective_stats`` reads from the reference's HLO.

``torch.distributed.tensor`` is imported only on the mesh path: a program
without a mesh never loads it.
"""

from __future__ import annotations

import collections
import itertools
import math
import os
import sys

import torch
import torch.distributed as dist

UE_AXIS = "ue"
CB_AXIS = "cb"
CELL_AXIS = "cell"
HOST_AXIS = "host"

# Mesh axis -> [all-gathers made, bytes they returned]; reset_collectives
# clears it.  Gathers over an axis of one rank are made and counted too.
COLLECTIVES: dict[str, list[int]] = collections.defaultdict(lambda: [0, 0])


def reset_collectives() -> None:
    COLLECTIVES.clear()


def collective_stats() -> dict:
    """{axis: {"count": all-gathers, "bytes": bytes returned}}."""
    return {a: {"count": c, "bytes": b} for a, (c, b) in sorted(COLLECTIVES.items())}


# ------------------------------------------------------------ process groups

def local_rank() -> int:
    """This rank's index on its host: LOCAL_RANK, else rank % LOCAL_WORLD_SIZE."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % local_world_size()


def local_world_size() -> int:
    """Ranks per host: LOCAL_WORLD_SIZE, else the whole world."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def host_of(rank: int) -> int:
    return rank // local_world_size()


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, backend: str = "nccl",
                     init_method: str | None = None) -> None:
    """Join the process group as rank ``process_id`` of ``num_processes``.

    ``init_method`` (a ``file://`` or ``tcp://`` URL) takes precedence over
    ``coordinator_address`` ("host:port", as ``tcp://host:port``); with
    neither, the ``env://`` variables of a launcher.  Where a CUDA device is
    visible, the rank's current device becomes ``cuda:local_rank()`` (modulo
    the visible devices, so several gloo ranks may share one card) before
    any mesh is built.  NCCL on a host without a CUDA device raises."""
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' needs a CUDA device, and "
                           "torch.cuda.is_available() is false; use "
                           "backend='gloo' for the CPU")
    if init_method is None:
        init_method = (f"tcp://{coordinator_address}" if coordinator_address
                       else "env://")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())


def rank_device(device_type: str = "cuda") -> torch.device:
    """The device this rank drives: the current CUDA device, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


# -------------------------------------------------------------------- meshes

def _mesh(device_type: str, ranks, shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.as_tensor(ranks).reshape(shape),
                      mesh_dim_names=names)


def _split(n: int, n_ue: int | None, n_cb: int | None) -> tuple[int, int]:
    """(n_ue, n_cb) with n_ue * n_cb == n; a missing one from the other,
    both missing: all on 'ue'."""
    if n_ue is None and n_cb is None:
        n_ue, n_cb = n, 1
    elif n_ue is None:
        n_ue = n // n_cb
    elif n_cb is None:
        n_cb = n // n_ue
    if n_ue * n_cb != n:
        raise ValueError(f"(ue {n_ue}, cb {n_cb}) does not cover {n} ranks")
    return n_ue, n_cb


def _ranks(ranks) -> list[int]:
    return list(range(dist.get_world_size())) if ranks is None else list(ranks)


def make_host_mesh(n_ue: int | None = None, n_cb: int | None = None,
                   ranks=None, device_type: str = "cuda"):
    """3-D (host, ue, cb) mesh with the host boundary on the leading axis.

    Ranks are grouped by host, so gathers over 'ue' / 'cb' stay within a
    host and only 'host' crosses hosts.  Independent work (carriers of
    multi_cell_*_slot_batch) sharded over 'host' needs no collective
    across hosts."""
    by_host: dict[int, list[int]] = {}
    for r in _ranks(ranks):
        by_host.setdefault(host_of(r), []).append(r)
    hosts = sorted(by_host)
    per_host = len(by_host[hosts[0]])
    if any(len(by_host[h]) != per_host for h in hosts):
        raise ValueError(f"hosts hold unequal rank counts: "
                         f"{ {h: len(v) for h, v in by_host.items()} }")
    n_ue, n_cb = _split(per_host, n_ue, n_cb)
    return _mesh(device_type, [by_host[h] for h in hosts],
                 (len(hosts), n_ue, n_cb), (HOST_AXIS, UE_AXIS, CB_AXIS))


def make_mesh_hostmajor(n_ue: int, n_cb: int, ranks=None,
                        device_type: str = "cuda"):
    """2-D (ue, cb) mesh over every host's ranks, host-major on 'ue': the
    single-cell slot step's gathers over 'ue' cross hosts."""
    ordered = sorted(_ranks(ranks), key=lambda r: (host_of(r), r))
    if n_ue * n_cb != len(ordered):
        raise ValueError(f"(ue {n_ue}, cb {n_cb}) does not cover "
                         f"{len(ordered)} ranks")
    return _mesh(device_type, ordered, (n_ue, n_cb), (UE_AXIS, CB_AXIS))


def make_mesh(n_ue: int | None = None, n_cb: int | None = None, ranks=None,
              device_type: str = "cuda"):
    """2-D (ue, cb) mesh over the ranks (default: every rank on 'ue').  UE
    rows shard over 'ue', codeblock rows over ('ue', 'cb')."""
    ranks = _ranks(ranks)
    n_ue, n_cb = _split(len(ranks), n_ue, n_cb)
    return _mesh(device_type, ranks, (n_ue, n_cb), (UE_AXIS, CB_AXIS))


def make_cell_mesh(n_cell: int, n_ue: int | None = None,
                   n_cb: int | None = None, ranks=None,
                   device_type: str = "cuda"):
    """3-D (cell, ue, cb) mesh: independent carriers on the leading axis,
    UE and codeblock partitioning within each cell."""
    ranks = _ranks(ranks)
    if len(ranks) % n_cell:
        raise ValueError(f"{len(ranks)} ranks do not split into {n_cell} cells")
    n_ue, n_cb = _split(len(ranks) // n_cell, n_ue, n_cb)
    return _mesh(device_type, ranks, (n_cell, n_ue, n_cb),
                 (CELL_AXIS, UE_AXIS, CB_AXIS))


# ------------------------------------------------------------------- layouts

def spec_axes(mesh, spec) -> tuple[str, ...]:
    """The mesh axes a PartitionSpec-like ``spec`` shards the leading dim
    over: ``()`` / ``(None,)`` replicate, ``(AXIS,)`` or ``((A, B),)``
    shard; the axes must follow the mesh's order."""
    spec = tuple(spec)
    if any(s is not None for s in spec[1:]):
        raise ValueError(f"only the leading dim is sharded here, got {spec}")
    first = spec[0] if spec else None
    axes = () if first is None else (first,) if isinstance(first, str) else tuple(first)
    names = mesh.mesh_dim_names
    pos = [names.index(a) for a in axes]
    if pos != sorted(set(pos)):
        raise ValueError(f"spec axes {axes} must follow the mesh's {names}")
    return axes


def coordinate(mesh) -> tuple[int, ...]:
    """This rank's coordinate on ``mesh`` (``()`` without a mesh)."""
    return () if mesh is None else tuple(mesh.get_coordinate())


def row_block(n: int, mesh, axes, coord=None) -> tuple[int, int]:
    """Rows [lo, hi) of ``n`` that the rank at ``coord`` (default: this
    rank) holds when dim 0 is split over ``axes`` (nested torch.chunk in
    mesh order, DTensor's split)."""
    if mesh is None or not axes:
        return 0, n
    coord = coordinate(mesh) if coord is None else coord
    lo, size = 0, n
    for a in axes:
        d = mesh.mesh_dim_names.index(a)
        chunk = -(-size // mesh.size(d)) if size else 0
        start = min(coord[d] * chunk, size)
        lo, size = lo + start, min(chunk, size - start)
    return lo, lo + size


def is_dtensor(x) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _sharded_axes(x) -> tuple[str, ...]:
    from torch.distributed.tensor import Replicate, Shard
    axes = []
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(p, Shard) and p.dim == 0:
            axes.append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} on '{name}': only Shard(0) and "
                             "Replicate() layouts are taken")
    return tuple(axes)


def wrap(local: torch.Tensor, mesh, axes, shape):
    """A rank's block ``local`` of a global tensor of ``shape`` as a DTensor
    with dim 0 split over ``axes`` (``local`` itself without a mesh)."""
    if mesh is None:
        return local
    from torch.distributed.tensor import DTensor, Replicate, Shard
    placements = [Shard(0) if a in axes else Replicate()
                  for a in mesh.mesh_dim_names]
    shape = torch.Size(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def _gather(local: torch.Tensor, mesh, axes, n: int) -> torch.Tensor:
    """All-gather over ``axes[-1]``, the innermost sharded axis, of the
    blocks of an ``n``-row dim 0 split over ``axes``: afterwards the rank
    holds its block under ``axes[:-1]``.  Blocks are padded to the longest
    and sent as bytes (every backend takes uint8)."""
    axis = axes[-1]
    d = mesh.mesh_dim_names.index(axis)
    coord = list(coordinate(mesh))
    sizes = []
    for j in range(mesh.size(d)):
        coord[d] = j
        lo, hi = row_block(n, mesh, axes, coord)
        sizes.append(hi - lo)
    longest, rest = max(sizes), local.shape[1:]
    if longest == 0:
        return local
    pad = local.new_zeros((longest - local.shape[0], *rest))
    buf = torch.cat([local, pad]).contiguous().reshape(longest, -1).view(torch.uint8)
    parts = [torch.empty_like(buf) for _ in sizes]
    dist.all_gather(parts, buf, group=mesh.get_group(axis))
    COLLECTIVES[axis][0] += 1
    COLLECTIVES[axis][1] += buf.numel() * len(parts)
    out = torch.cat([p[:k] for p, k in zip(parts, sizes)])
    return out.view(local.dtype).reshape(sum(sizes), *rest)


def take(x, mesh, need, shape=None, into=()) -> torch.Tensor:
    """Rows ``need(coord)`` = [lo, hi) of ``x`` viewed as ``shape`` (a
    row-major reshape of ``x``, default its own shape) as a plain tensor on
    this rank, for a program whose rows are split over the axes ``into``.

    ``x`` is a global tensor (the same on every rank: sliced, nothing
    moves) or a DTensor on ``mesh``.  A DTensor is all-gathered, innermost
    sharded axis first, over every axis it is split on beyond the common
    prefix with ``into`` (whatever their sizes, so a program makes the same
    collectives at every world size), then over more axes while a rank's
    block does not hold the rows ``need`` gives it.  The decision reads
    ``need`` at every coordinate, so all ranks of a group make the same
    gathers."""
    shape = tuple(x.shape) if shape is None else tuple(shape)
    row = math.prod(shape[1:])
    if not is_dtensor(x):
        lo, hi = need(coordinate(mesh))
        return x.reshape(shape)[lo:hi]
    if x.device_mesh is not mesh:
        raise ValueError("the DTensor lies on another mesh than the program's")
    n0, e0 = x.shape[0], math.prod(x.shape[1:])

    def src(lo, hi):        # x's dim-0 rows that hold target rows [lo, hi)
        return (lo * row) // e0 if e0 else 0, -(-(hi * row) // e0) if e0 else 0

    def held(c):
        lo, hi = need(c)
        a, b = src(lo, hi)
        blo, bhi = row_block(n0, mesh, axes, c)
        return lo == hi or (blo <= a and b <= bhi)

    axes = _sharded_axes(x)
    keep = 0
    while keep < min(len(axes), len(into)) and axes[keep] == into[keep]:
        keep += 1
    local = x.to_local()
    coords = list(itertools.product(*(range(k) for k in mesh.shape)))
    while len(axes) > keep or (axes and not all(held(c) for c in coords)):
        local = _gather(local, mesh, axes, n0)
        axes = axes[:-1]
    lo, hi = need(coordinate(mesh))
    if lo == hi:
        return local.new_empty((0, *shape[1:]))
    a, b = src(lo, hi)
    blo = row_block(n0, mesh, axes)[0]
    flat = local[a - blo:b - blo].reshape(-1)
    return flat[lo * row - a * e0:hi * row - a * e0].reshape(hi - lo, *shape[1:])
