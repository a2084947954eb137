"""One CUDA graph per full-slot call: the gNB entry points capture their
whole call once and replay it.

The port's four full-slot entry points (``full_cell.gnb_dl_slot_batch``,
``gnb_ul_slot_batch`` and their ``_mimo`` pair) hand their body to
``STEP_GRAPHS``.  Eager, a step issues some 330-440 kernel launches and the
Python around them, and the host takes longer to issue a step than the
device takes to run it.  A replay issues one graph launch, a copy of each
input into the graph's own and a copy of each output out of it.  The
captured body is the eager body, so a replay launches the same kernels in
the same order on the same data, and its outputs equal the eager ones bit
for bit.

How a call runs depends only on what it can observe (``observe``,
``eager_reason``, ``StepGraphs.mode``):

* eager, ``mesh``: a mesh or a DTensor input (``parallel/multihost.py``'s
  collectives read the device on the host);
* eager, ``cpu``: the device or an input off CUDA (a copy from the host
  waits for the device);
* eager, ``profiler``: a torch profiler records, so the stage spans keep
  their ranges over the operations they launch;
* eager, ``grad``: an input requires grad;
* eager, ``first_call``: the first call of a key, which builds every cached
  table, cuFFT plan and kernel attribute that the capture then only reads;
* ``capture``: the key's second call: captured, then replayed;
* ``replay``: every later call of the key.

The key (``graph_key``) is the entry point, the device, each input's shape,
dtype, stride and device (or None), and the static arguments: the
configuration, S, and in the UL ``num_iters``, ``soft_flat`` and
``early_stop``.  A replay copies the caller's inputs into the graph's
static inputs and hands back copies of its static outputs, with their
shapes and strides, so no tensor that a call returned is written by a
later call, and a carry fed back keys the same graph.  The capture runs
on a side stream and makes no host synchronisation.

``utils.tracing.graph_calls`` counts the calls by how they ran; a
capture's seconds count in ``utils.tracing.builds`` as
``graph.<entry point>``; a replay adds the kernel launches that its capture
counted to ``cuda_build.LAUNCHES``, since the wrappers that count them do
not run then.  A graph reads the cached device tables (``cached_build``)
where they lay when it was captured: clearing those caches while it lives
would leave it reading freed memory.
"""

from __future__ import annotations

import collections

import torch
from torch.autograd import _profiler_enabled

from .. import cuda_build
from ..device import resolve_device
from ..utils.tracing import builds, graph_calls
from .mesh import is_dtensor

# Why a call runs eager, in the order ``eager_reason`` checks them.
EAGER = ("mesh", "cpu", "profiler", "grad", "first_call")
# Captured calls kept; the one replayed longest ago goes first.
LIMIT = 8


def eager_reason(mesh: bool, off_cuda: bool, profiling: bool,
                 grad: bool) -> str | None:
    """Why a call must run eager whatever its key, or None."""
    for reason, seen in zip(EAGER, (mesh, off_cuda, profiling, grad)):
        if seen:
            return reason
    return None


def observe(args, dev: torch.device, mesh) -> tuple[bool, bool, bool, bool]:
    """``eager_reason``'s arguments for a call on ``dev`` with the inputs
    ``args`` (None for one left out)."""
    given = [a for a in args if a is not None]
    tensors = [a for a in given if isinstance(a, torch.Tensor)]
    on_mesh = mesh is not None or any(is_dtensor(a) for a in given)
    off_cuda = (dev.type != "cuda" or len(tensors) < len(given)
                or any(a.device != dev for a in tensors))
    return (on_mesh, off_cuda, _profiler_enabled(),
            any(a.requires_grad for a in tensors))


def _describe(t):
    return None if t is None else (tuple(t.shape), t.dtype, t.stride(), t.device)


def graph_key(entry: str, dev: torch.device, args, **static) -> tuple:
    """What a captured call holds fixed: a call with another key takes
    another graph."""
    return (entry, dev, tuple(_describe(a) for a in args),
            tuple(sorted(static.items())))


def _empty_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor of ``t``'s shape, dtype and device, with its
    strides where no two elements share memory, else contiguous."""
    dims = sorted((st, sz) for sz, st in zip(t.shape, t.stride()) if sz > 1)
    span = 1
    for st, sz in dims:
        if st < span:
            return torch.empty(t.shape, dtype=t.dtype, device=t.device)
        span = st * sz
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)


def _copy(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``src`` into ``dst`` of its shape.  Where both have the same strides
    but leave gaps (a carry that is a column slice of the decoder input),
    one dense copy of the bytes from the first element to the last, gaps
    and all: an elementwise copy of strided int8 runs far below the
    card's bandwidth."""
    if dst.is_contiguous() or dst.stride() != src.stride() or src.numel() == 0:
        return dst.copy_(src)
    n = 1 + sum((sz - 1) * st for sz, st in zip(src.shape, src.stride()))
    dst.as_strided((n,), (1,)).copy_(src.as_strided((n,), (1,)))
    return dst


def _fresh(x):
    """Copies of the tensors in ``x`` (a tensor or a dict of them, as the
    entry points return), laid out as they are."""
    if isinstance(x, torch.Tensor):
        return _copy(_empty_like(x), x)
    if isinstance(x, dict):
        return {k: _fresh(v) for k, v in x.items()}
    return x


class Captured:
    """One captured call: its graph (``replay()``), static inputs and
    outputs, and the kernel launches its body counted."""

    def __init__(self, graph, static_in: tuple, static_out, launches: dict):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.launches = launches

    def replay(self, args):
        """The outputs for inputs ``args``: fresh tensors."""
        for mine, a in zip(self.static_in, args):
            if mine is not None:
                _copy(mine, a)
        self.graph.replay()
        return _fresh(self.static_out)


_SIDE: dict[torch.device, torch.cuda.Stream] = {}


def _record(fn, static_in: tuple):
    """(the CUDA graph of ``fn(*static_in)``, its outputs), captured on a
    side stream of the inputs' device.  Nothing runs on the device here."""
    dev = next(a.device for a in static_in if a is not None)
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream(device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev), torch.cuda.stream(_SIDE[dev]):
        graph.capture_begin()
        try:
            out = fn(*static_in)
        except BaseException:
            try:
                graph.capture_end()     # ends the stream's capture; fn's error stands
            except RuntimeError:
                pass
            raise
        graph.capture_end()
    return graph, out


def capture(fn, args) -> Captured:
    """``fn`` captured on static inputs laid out as ``args``, with the
    kernel launches that its wrappers counted."""
    static_in = tuple(None if a is None else _empty_like(a) for a in args)
    before = collections.Counter(cuda_build.LAUNCHES)
    graph, out = _record(fn, static_in)
    launches = collections.Counter(cuda_build.LAUNCHES)
    launches.subtract(before)
    return Captured(graph, static_in, out, dict(+launches))


class StepGraphs:
    """The full-slot entry points' captured calls, by key."""

    def __init__(self):
        self._seen: set = set()
        self._graphs: collections.OrderedDict = collections.OrderedDict()

    def mode(self, key) -> str:
        """How a call of ``key`` that may be graphed runs."""
        if key in self._graphs:
            return "replay"
        return "capture" if key in self._seen else "first_call"

    def __call__(self, entry: str, fn, args: tuple, device, mesh, **static):
        """``fn(*args)``: eager, or captured and replayed (module docstring).
        ``static``: the arguments that ``fn`` holds fixed."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        reason = eager_reason(*observe(args, dev, mesh))
        if reason is not None:
            graph_calls.count(entry, reason)
            return fn(*args)
        return self.run(entry, graph_key(entry, dev, args, **static), fn, args)

    def run(self, entry: str, key, fn, args: tuple):
        """A call that may be graphed, by its key's history."""
        how = self.mode(key)
        graph_calls.count(entry, how)
        if how == "first_call":
            out = fn(*args)
            self._seen.add(key)
            return out
        if how == "capture":
            with builds.timed(f"graph.{entry}"):
                self._graphs[key] = capture(fn, args)
            while len(self._graphs) > LIMIT:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
            cuda_build.LAUNCHES.update(self._graphs[key].launches)
        return self._graphs[key].replay(args)


STEP_GRAPHS = StepGraphs()
