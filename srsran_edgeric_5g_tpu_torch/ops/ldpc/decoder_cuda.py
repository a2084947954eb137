"""Layered min-sum LDPC decoders: the CUDA kernel and its plain twins.

Port of the two Pallas TPU kernels of ``srsran_edgeric_5g_tpu/ops/ldpc/
decoder_pallas.py``: K1 ``decode_pallas`` and K2 ``decode_pallas_int8``.
The kernel is ``csrc/ldpc_layered.cu`` (one CTA per codeblock, Zc lanes on
the thread axis, rows specialised by degree, the posterior and the
compressed check-to-variable messages in shared memory, a bit-packed
syndrome; its header says what bounds it).  ``decode_layered`` (K1) has two
modes:

  * f32 (``wire=False``): ``decode_pallas``'s normalised min-sum
    (α = 0.8).  With ``strict`` (the default) its hard bits are
    ``post < 0`` and the card takes Zc >= ``MIN_ZC``, as ``decode_pallas``
    asserts: ``decode(schedule="pallas")``.  With ``strict=False`` the hard
    bits follow the layered schedule's ``l <= 0`` and every NR lifting size
    runs: ``decode(schedule="auto")``, which the per-UE MIMO receiver
    calls;
  * wire (``wire=True``): the reference's ``layered_wire`` semantics on int8
    wire-domain input, which the main path's ``decode(schedule="wire_auto")``
    computes, at every NR lifting size.

``decode_int8`` (K2) is ``decode_pallas_int8``: int8 input, int16
posterior, int8 messages, 13/16 normalisation, with its tile early exit
(a tile of ``b_tile`` codeblocks stops once all of them meet parity).

Each wrapper launches the kernel for a CUDA tensor and raises if it cannot;
for a CPU tensor it runs its ``*_plain`` twin, the same function in plain
PyTorch, which the CPU tests and the on-card comparison use.
``decode_layered``'s early stop is the reference's batch rule over groups
of ``exit_group`` consecutive codeblocks, in the kernel and its twin alike:
the JAX ``layered`` / ``layered_wire`` schedules stop the whole batch of a
call once every codeword meets parity (the default group), under a
``vmap`` over TBs each TB's codeblocks (a group of C), and under its
sharding the global batch (``process_groups``: every rank's codeblocks).
A group of 1 is the exit per codeblock, which gives other bits on
waterfall input.  The kernel's group exit runs no sweep twice: a codeblock
that stops before its group keeps its state and resumes from it; the
sweeps it ran are counted on the card (``executed_sweeps``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import cuda_build
from .decoder import (DEFAULT_ITERS, DEFAULT_SCALING, _plan_tensors,
                      batch_met, check_parity, exit_ranks, get_decode_plan,
                      hard_decision, init_state, reduce_over, sweep)
from .graph import get_graph
from ...utils.tracing import cached_build

KERNEL = "ldpc_layered"         # K1's launch counter (and the library)
KERNEL_INT8 = "ldpc_int8"       # K2's launch counter
# K1's group exit: each launch of its resume kernel (a round; num_iters per
# call over one rank), counted apart from K1's one per call of
# decode_layered.
KERNEL_RESUME = "ldpc_layered.resume"
MODE_F32, MODE_WIRE, MODE_INT8 = 0, 1, 2   # the kernel's template modes
INT8_CLAMP = 120  # decoder_pallas.LLR_CLAMP: K2's message clip
MIN_ZC = 64      # decoder_pallas.MIN_ZC: the f32 and int8 modes' Zc floor
MAX_ZC = 384     # largest NR lifting size (one thread per lane)
# Row degrees the kernel has a row routine for (the switch in sweep<M>):
# BG1 {3..10, 19}, BG2 {3, 4, 5, 6, 8, 10}.
ROW_DEGREES = frozenset({3, 4, 5, 6, 7, 8, 9, 10, 19})
SMALL_DEG = 11   # kSmallDeg: rows above it keep sm2 in an extra byte
# Wire mode on the card: |R| <= 120 * scaling must stay within ±120 (the
# kernel's promotion sum relies on it, see kFrozen in csrc/ldpc_layered.cu).
MAX_WIRE_SCALING = 1.0


def cuda_supported(zc: int, mode: int, strict: bool = True) -> bool:
    """Whether the kernel takes lifting size ``zc`` in ``mode``: wire mode,
    and f32 mode with the ``l <= 0`` rule (``strict=False``), every NR
    lifting size; ``decode_pallas``'s f32 mode and int8 Zc >= MIN_ZC (the
    floor that ``decode_pallas`` and ``decode_pallas_int8`` assert)."""
    every = mode == MODE_WIRE or (mode == MODE_F32 and not strict)
    return (1 if every else MIN_ZC) <= zc <= MAX_ZC


def _check_input(llrs: torch.Tensor, bg: int, zc: int, wire: bool) -> None:
    g = get_graph(bg, zc)
    want = torch.int8 if wire else torch.float32
    if llrs.dtype != want:
        raise TypeError(f"{'wire' if wire else 'f32'} mode takes {want} LLRs, "
                        f"got {llrs.dtype}")
    if llrs.ndim != 2 or llrs.shape[1] != g.n_full:
        raise ValueError(f"LLRs must be (B, {g.n_full}) for BG{bg} Zc={zc}, "
                         f"got {tuple(llrs.shape)}")


def _strict(wire: bool, strict: bool | None) -> bool:
    """The hard rule: ``post < 0`` (strict) or ``l <= 0``.  Wire mode is
    always ``l <= 0``; f32 mode is strict unless asked otherwise."""
    if strict is None:
        return not wire
    if wire and strict:
        raise ValueError("wire mode's hard rule is l <= 0 (strict=False)")
    return strict


def decode_layered(llrs: torch.Tensor, bg: int, zc: int,
                   num_iters: int = DEFAULT_ITERS,
                   scaling: float = DEFAULT_SCALING,
                   wire: bool = False, early_stop: bool = False,
                   strict: bool | None = None, exit_group: int | None = None,
                   process_groups=None):
    """Decode (B, cols*Zc) LLRs -> (hard (B, kb*Zc) int8, ok (B,) bool,
    sweeps (B,) int32 run per codeblock).

    ``wire=True`` takes int8 wire-domain LLRs, ``wire=False`` float32.
    ``strict`` picks the f32 mode's hard rule (``post < 0``, the default;
    False: ``l <= 0``).  With ``early_stop`` every codeblock of a group of
    ``exit_group`` consecutive ones (the whole batch by default) runs the
    sweeps after which all of the group first meet parity, or ``num_iters``.
    ``process_groups`` (``torch.distributed`` groups) makes the group every
    codeblock of every rank of their product; each rank calls, also with
    no codeblocks, and ``exit_group`` must then be None.  Groups of one rank
    add no collective.  A CUDA tensor runs the kernel (or raises); a CPU
    tensor runs the plain version."""
    _check_input(llrs, bg, zc, wire)
    strict = _strict(wire, strict)
    groups = exit_ranks(process_groups) if early_stop and num_iters > 0 else []
    if groups and exit_group is not None:
        raise ValueError("exit_group and process_groups exclude each other")
    b = llrs.shape[0]
    group = _exit_group(b, early_stop, exit_group)
    if b == 0 and not groups:
        return empty_result(bg, zc, llrs.device)
    if llrs.device.type == "cpu":
        return decode_layered_plain(llrs, bg, zc, num_iters, scaling, wire,
                                    early_stop, strict, exit_group, groups)
    out = _launch(llrs, MODE_WIRE if wire else MODE_F32, bg, zc, num_iters,
                  scaling, group, strict=strict, groups=groups)
    if b:
        cuda_build.LAUNCHES[KERNEL] += 1
    return out


def _exit_group(b: int, early_stop: bool, exit_group: int | None) -> int:
    """The kernel's exit group: 0 without early stop, else the group size
    (at most the batch)."""
    if exit_group is not None and exit_group < 1:
        raise ValueError(f"exit_group must be >= 1, got {exit_group}")
    return min(exit_group or b, b) if early_stop else 0


def empty_result(bg: int, zc: int, device: torch.device):
    """(hard (0, kb*Zc) int8, ok (0,) bool, sweeps (0,) int32): a batch of
    no codeblocks (an empty shard), returned without a launch."""
    g = get_graph(bg, zc)
    return (torch.empty((0, g.kb * zc), dtype=torch.int8, device=device),
            torch.empty((0,), dtype=torch.bool, device=device),
            torch.empty((0,), dtype=torch.int32, device=device))


def _check_cuda(llrs: torch.Tensor, bg: int, zc: int, mode: int,
                scaling: float, strict: bool) -> None:
    if llrs.device.type != "cuda":
        raise ValueError(f"no {KERNEL} kernel for device {llrs.device}")
    if not cuda_supported(zc, mode, strict):
        raise ValueError(f"{KERNEL} mode {mode} takes Zc <= {MAX_ZC}, and "
                         f"Zc >= {MIN_ZC} in int8 mode and in f32 mode with "
                         f"the post < 0 rule; got {zc}")
    if not llrs.is_contiguous():
        raise ValueError("LLRs must be contiguous")
    degrees = set(_row_degrees(bg, zc))
    if not degrees <= ROW_DEGREES:
        raise ValueError(f"row degrees {sorted(degrees - ROW_DEGREES)} have no "
                         "row routine in the kernel")
    if mode == MODE_WIRE and not 0.0 <= scaling <= MAX_WIRE_SCALING:
        raise ValueError(f"wire mode takes 0 <= scaling <= {MAX_WIRE_SCALING} "
                         f"on the card, got {scaling}")


def _row_degrees(bg: int, zc: int) -> np.ndarray:
    g = get_graph(bg, zc)
    return np.bincount(g.edge_row, minlength=g.rows)


def _n_big(bg: int, zc: int) -> int:
    """Rows whose compressed R keeps sm2 in an extra byte."""
    return int((_row_degrees(bg, zc) > SMALL_DEG).sum())


def _launch(llrs, mode, bg, zc, num_iters, scaling, exit_group, strict=True,
            groups=()):
    """Run the kernel on a CUDA tensor: the fused path (all sweeps in one
    launch).  ``exit_group`` 0 runs every sweep, 1 stops each codeblock at
    its own zero syndrome, g > 1 stops each group of g consecutive
    codeblocks together: in K1's modes by the group exit's resume rounds
    (each launch counted under ``KERNEL_RESUME``), for K2 by the tiled
    path (one launch per sweep, per-tile exit).  ``groups`` (K1, process
    groups of more than one rank) extends the group, the whole local batch,
    over their ranks (``_rounds_over_ranks``).  ``strict=False`` gives the
    f32 mode the hard rule ``l <= 0``.  Returns (hard, ok, sweeps)."""
    _check_cuda(llrs, bg, zc, mode, scaling, strict)
    g = get_graph(bg, zc)
    dev = llrs.device
    b = llrs.shape[0]
    tables = tuple(t.data_ptr() for t in _edge_tables(bg, zc, dev))
    hard = torch.empty((b, g.kb * zc), dtype=torch.int8, device=dev)
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    sweeps = torch.empty((b,), dtype=torch.int32, device=dev)
    n_big = _n_big(bg, zc)
    graph = (g.rows, g.cols, g.kb, g.num_edges, n_big, zc)
    scale = (float(np.float32(scaling)), int(scaling * 65536))
    lib = _library()
    tiled = mode == MODE_INT8 and exit_group > 1 and num_iters > 0
    grouped = (mode != MODE_INT8 and num_iters > 0
               and (exit_group > 1 or bool(groups)))
    # Compressed R in device memory: the f32 mode's and the tiled path's.
    r_state = (torch.empty((b, lib.ldpc_layered_state_bytes(mode, g.rows, n_big,
                                                             zc)),
                           dtype=torch.uint8, device=dev)
               if tiled or mode == MODE_F32 else None)
    ctrl = keep = None
    if grouped:
        # The group exit: targets, then per round the groups that missed
        # parity; and each codeblock's kept state.
        ctrl = torch.zeros((-(-b // exit_group) if b else 1) * (num_iters + 1),
                           dtype=torch.int32, device=dev)
        keep = torch.empty((b, lib.ldpc_layered_keep_bytes(mode, g.rows, g.cols,
                                                            n_big, zc)),
                           dtype=torch.uint8, device=dev)
    executed = 0 if mode == MODE_INT8 else _executed(dev).data_ptr()
    ptr = lambda t: 0 if t is None else t.data_ptr()
    state = (hard.data_ptr(), ok.data_ptr(), sweeps.data_ptr(), ptr(r_state),
             ptr(keep), ptr(ctrl), executed, *tables, b, *graph, num_iters,
             *scale, exit_group, int(mode == MODE_F32 and not strict))
    rounds = num_iters if grouped and not groups else 0
    rc = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tiled:
            l_state = torch.empty((b, g.cols * zc), dtype=torch.int16, device=dev)
            viol = torch.zeros((num_iters, b // exit_group), dtype=torch.int32,
                               device=dev)
            rc = lib.ldpc_int8_decode_tiled(
                llrs.data_ptr(), l_state.data_ptr(), r_state.data_ptr(),
                viol.data_ptr(), hard.data_ptr(), ok.data_ptr(),
                sweeps.data_ptr(), *tables, b, *graph, num_iters, exit_group,
                stream)
        elif b:
            rc = lib.ldpc_layered_decode(llrs.data_ptr(), mode, *state, rounds,
                                         stream)
        if rc == 0 and grouped and b:
            cuda_build.LAUNCHES[KERNEL_RESUME] += rounds

        def resume(r):
            if not b:
                return 0
            out = lib.ldpc_layered_resume(mode, *state, r, stream)
            cuda_build.LAUNCHES[KERNEL_RESUME] += out == 0
            return out

        if rc == 0 and groups:
            rc = _rounds_over_ranks(ctrl, groups, num_iters, resume)
    if rc != 0:
        smem = lib.ldpc_layered_smem_bytes(mode, g.rows, g.cols, g.num_edges,
                                           n_big, zc)
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {rc} (mode "
                           f"{mode}, BG{bg} Zc={zc}, {smem} B shared memory "
                           f"per block{', tiled' if tiled else ''})")
    return hard, ok, sweeps


def _rounds_over_ranks(ctrl: torch.Tensor, groups, num_iters: int,
                       resume) -> int:
    """The group exit over the ranks of ``groups``, the local batch one
    group: the target all-reduced (max) and read, then round after round
    ``resume(r)`` and its missed-parity flag all-reduced (max) and read,
    until no codeblock of any rank missed parity or the target reached
    num_iters.  Every rank reads the same values, so all make the same
    collectives, also one with no codeblocks (``resume`` launches nothing
    there).  Returns the first launch error, else 0."""
    target = int(reduce_over(ctrl[:1], groups, "max").item())
    for r in range(num_iters):
        if target == 0 or target + r > num_iters:
            break
        rc = resume(r)
        if rc:
            return rc
        if target + r == num_iters:
            break
        if not int(reduce_over(ctrl[1 + r:2 + r], groups, "max").item()):
            break
    return 0


_EXECUTED: dict = {}


def _executed(dev: torch.device) -> torch.Tensor:
    """The device's count of sweeps K1 ran (one int64; every launch adds)."""
    key = (dev.type, dev.index)
    if key not in _EXECUTED:
        _EXECUTED[key] = torch.zeros((1,), dtype=torch.int64, device=dev)
    return _EXECUTED[key]


def reset_executed_sweeps() -> None:
    """Zero every device's count of the sweeps K1 ran."""
    for t in _EXECUTED.values():
        t.zero_()


def executed_sweeps(dev: torch.device | str = "cuda") -> int:
    """The sweeps K1's launches ran on ``dev`` since the last reset (a host
    read): with no sweep repeated, the sum of the ``sweeps`` outputs."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return int(_executed(dev).item())


@cached_build
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ldpc_layered_smem_bytes.argtypes = [i32] * 6
    lib.ldpc_layered_smem_bytes.restype = ctypes.c_size_t
    lib.ldpc_layered_state_bytes.argtypes = [i32] * 4
    lib.ldpc_layered_state_bytes.restype = ctypes.c_size_t
    lib.ldpc_layered_keep_bytes.argtypes = [i32] * 5
    lib.ldpc_layered_keep_bytes.restype = ctypes.c_size_t
    lib.ldpc_layered_blocks_per_sm.argtypes = [i32] * 6
    lib.ldpc_layered_blocks_per_sm.restype = i32
    shared = [ptr] * 11 + [i32] * 8 + [ctypes.c_float, i32, i32, i32, i32, ptr]
    lib.ldpc_layered_decode.argtypes = [ptr, i32] + shared
    lib.ldpc_layered_decode.restype = i32
    lib.ldpc_layered_resume.argtypes = [i32] + shared
    lib.ldpc_layered_resume.restype = i32
    lib.ldpc_int8_decode_tiled.argtypes = [ptr] * 11 + [i32] * 9 + [ptr]
    lib.ldpc_int8_decode_tiled.restype = i32
    return lib


def blocks_per_sm(mode: int, bg: int, zc: int) -> int:
    """CTAs of the fused path that the current card keeps resident per SM
    (the occupancy calculator's answer for this shape)."""
    g = get_graph(bg, zc)
    return _library().ldpc_layered_blocks_per_sm(mode, g.rows, g.cols,
                                                 g.num_edges, _n_big(bg, zc), zc)


@cached_build
def _edge_tables(bg: int, zc: int, device: torch.device):
    """(row_start (rows+1,), row_sync (rows,), edge_col (E,), edge_shift
    (E,)) int32 on device; edges row-major, columns ascending within a row.
    row_sync marks the rows the kernel ends with a barrier (``row_barriers``)."""
    g = get_graph(bg, zc)
    row_start = np.concatenate([[0], np.cumsum(_row_degrees(bg, zc))])
    return tuple(torch.as_tensor(x.astype(np.int32), device=device)
                 for x in (row_start, row_barriers(bg, zc), g.edge_col,
                           g.edge_shift))


def row_barriers(bg: int, zc: int) -> np.ndarray:
    """(rows,) 1 where the kernel needs a barrier after a row: the next row
    shares a column with a row processed since the last barrier (so a
    thread may read what another wrote), and after the last row.  Rows
    between two barriers touch disjoint columns (BG1: 32 barriers of 46)."""
    g = get_graph(bg, zc)
    cols = [set(g.edge_col[g.edge_row == r].tolist()) for r in range(g.rows)]
    sync = np.zeros(g.rows, dtype=np.int32)
    dirty: set = set()
    for r in range(g.rows):
        dirty |= cols[r]
        if r == g.rows - 1 or cols[r + 1] & dirty:
            sync[r] = 1
            dirty = set()
    return sync


def decode_layered_plain(llrs: torch.Tensor, bg: int, zc: int,
                         num_iters: int = DEFAULT_ITERS,
                         scaling: float = DEFAULT_SCALING,
                         wire: bool = False, early_stop: bool = False,
                         strict: bool | None = None,
                         exit_group: int | None = None,
                         process_groups=None):
    """The kernel's function in plain PyTorch (any device).

    f32 mode follows ``_make_kernel`` (its running min / second-min with the
    ``a == m1`` rule gives the same messages as the argmin form used here),
    with hard bits ``post < 0``, or ``l <= 0`` when ``strict`` is False;
    wire mode follows ``layered_wire``.  With ``early_stop`` each group of
    ``exit_group`` consecutive codeblocks (the whole batch by default) stops
    once all of them meet parity (``layered`` / ``layered_wire``'s rule for
    one call); over ``process_groups`` the batch is every rank's (after each
    sweep an all-reduce of whether all of this rank's meet parity)."""
    _check_input(llrs, bg, zc, wire)
    strict = _strict(wire, strict)
    groups = exit_ranks(process_groups) if early_stop else []
    if groups and exit_group is not None:
        raise ValueError("exit_group and process_groups exclude each other")
    plan = get_decode_plan(bg, zc)
    l, r_msgs = init_state(llrs, plan, wire)
    b = llrs.shape[0]
    group = _exit_group(b, early_stop, exit_group)
    sweeps = torch.zeros((b,), dtype=torch.int32, device=llrs.device)
    active = torch.arange(b, device=llrs.device)
    for _ in range(num_iters):
        if groups:
            if b:
                sweep(l, r_msgs, bg, zc, scaling, wire)
            sweeps += 1
            if batch_met(check_parity(hard_decision(l, strict), bg, zc), groups):
                break
            continue
        if active.numel() == 0:
            break
        if active.numel() == b:
            sweep(l, r_msgs, bg, zc, scaling, wire)
            l_a = l
        else:
            l_a, r_a = l[active], r_msgs[active]
            sweep(l_a, r_a, bg, zc, scaling, wire)
            l[active], r_msgs[active] = l_a, r_a
        sweeps[active] += 1
        if group:
            done = check_parity(hard_decision(l_a, strict), bg, zc)
            still_open = torch.zeros((-(-b // group),), dtype=torch.bool,
                                     device=llrs.device)
            still_open[active[~done] // group] = True
            active = active[still_open[active // group]]
    hard = hard_decision(l, strict)
    return hard[:, :plan.kb * zc], check_parity(hard, bg, zc), sweeps


def pack_messages(r_msgs: torch.Tensor, bg: int, zc: int, mode: int):
    """The compressed form in which the kernel keeps R (``RowR`` in
    csrc/ldpc_layered.cu), in plain PyTorch: per-edge messages (B, rows,
    max_deg, Zc) -> (words (B, rows * row_words, Zc) int64 holding the 32-bit
    words, sm2 bytes (B, rows of degree > SMALL_DEG, Zc) int64).

    Every message of a min-sum row is ±sm1 but the first minimum's, ±sm2 >=
    sm1, so the row keeps sm1 = min |R|, sm2 = max |R|, amin = the first
    index of the largest |R| and one sign bit per edge (``signbit``, so a
    float -0.0 keeps its sign).  Integer modes: one word per row, ``flips |
    amin << 11 | sm2 << 16 | sm1 << 24``, or for a row of degree > SMALL_DEG
    ``flips | amin << 19 | sm1 << 24`` and sm2 in a byte; f32: three words,
    ``flips | amin << 24``, sm1 and sm2 as float32 bits."""
    b = r_msgs.shape[0]
    words, big = [], []
    for r, d in enumerate(_row_degrees(bg, zc).tolist()):
        m = r_msgs[:, r, :d]
        mag = m.abs()
        sm1, sm2 = mag.amin(dim=1), mag.amax(dim=1)
        amin = mag.argmax(dim=1).to(torch.int64)
        bit = torch.signbit(m).to(torch.int64) << torch.arange(d).reshape(1, d, 1)
        flips = bit.sum(dim=1)
        if mode == MODE_F32:
            words += [flips | amin << 24,
                      *(x.to(torch.float32).view(torch.int32).to(torch.int64)
                        & 0xffffffff for x in (sm1, sm2))]
            continue
        sm1, sm2 = sm1.to(torch.int64), sm2.to(torch.int64)
        if int(torch.maximum(sm1, sm2).max()) > 255:
            raise ValueError("a scaled magnitude does not fit its byte")
        if d <= SMALL_DEG:
            words.append(flips | amin << 11 | sm2 << 16 | sm1 << 24)
        else:
            words.append(flips | amin << 19 | sm1 << 24)
            big.append(sm2)
    empty = r_msgs.new_zeros((b, 0, zc), dtype=torch.int64)
    return (torch.stack(words, 1),
            torch.stack(big, 1) if big else empty)


def unpack_messages(words: torch.Tensor, big: torch.Tensor, bg: int, zc: int,
                    mode: int, dtype: torch.dtype) -> torch.Tensor:
    """``pack_messages``' inverse: the per-edge messages (B, rows, max_deg,
    Zc) of ``dtype``, R_j = (sign bit j ? -1 : 1) * (j == amin ? sm2 : sm1),
    zero past each row's degree."""
    degrees = _row_degrees(bg, zc).tolist()
    b = words.shape[0]
    out = torch.zeros((b, len(degrees), max(degrees), zc), dtype=dtype)
    n_big = 0
    for r, d in enumerate(degrees):
        if mode == MODE_F32:
            w, sm1, sm2 = (words[:, 3 * r + k] for k in range(3))
            sm1, sm2 = ((x & 0xffffffff).to(torch.int32).view(torch.float32)
                        for x in (sm1, sm2))
            flips, amin = w & 0xffffff, w >> 24
        else:
            w = words[:, r]
            if d <= SMALL_DEG:
                flips, amin = w & 0x7ff, (w >> 11) & 31
                sm2, sm1 = (w >> 16) & 255, w >> 24
            else:
                flips, amin, sm1 = w & 0x7ffff, (w >> 19) & 31, w >> 24
                sm2 = big[:, n_big]
                n_big += 1
        j = torch.arange(d).reshape(1, d, 1)
        mag = torch.where(j == amin[:, None], sm2[:, None], sm1[:, None]
                          ).to(dtype)
        out[:, r, :d] = torch.where(((flips[:, None] >> j) & 1) == 1, -mag, mag)
    return out


def _int8_input(llrs: torch.Tensor, bg: int, zc: int, b_tile: int
                ) -> torch.Tensor:
    """``decode_pallas_int8``'s checks and input conversion: Zc >= MIN_ZC,
    B % b_tile == 0, clip(round(llrs), ±127) as int8 (round half to even,
    as jnp.round)."""
    if zc < MIN_ZC:
        raise ValueError(f"decode_int8 takes Zc >= {MIN_ZC}, got {zc}")
    g = get_graph(bg, zc)
    if llrs.ndim != 2 or llrs.shape[1] != g.n_full:
        raise ValueError(f"LLRs must be (B, {g.n_full}) for BG{bg} Zc={zc}, "
                         f"got {tuple(llrs.shape)}")
    if b_tile < 1 or llrs.shape[0] % b_tile:
        raise ValueError(f"B = {llrs.shape[0]} is not a multiple of "
                         f"b_tile = {b_tile}")
    if llrs.dtype == torch.int8:          # integers: only -128 moves
        return torch.clamp(llrs, -127, 127).contiguous()
    return torch.clamp(torch.round(llrs.to(torch.float32)), -127, 127
                       ).to(torch.int8).contiguous()


def decode_int8(llrs: torch.Tensor, bg: int, zc: int,
                num_iters: int = DEFAULT_ITERS, b_tile: int = 32,
                early_stop: bool = False, *, with_sweeps: bool = False):
    """K2, ``decode_pallas_int8``'s counterpart: (B, cols*Zc) LLRs (any
    float or integer type in the ±127 wire range) -> (hard (B, kb*Zc) int8,
    ok (B,) bool), plus the sweeps run per codeblock when ``with_sweeps``.

    With ``early_stop`` a tile of ``b_tile`` consecutive codeblocks stops
    once every one of them meets parity; without it the result does not
    depend on ``b_tile``.  A CUDA tensor runs the kernel (or raises); a CPU
    tensor runs ``decode_int8_plain``."""
    x = _int8_input(llrs, bg, zc, b_tile)
    if x.shape[0] == 0:
        out = empty_result(bg, zc, x.device)
        return out if with_sweeps else out[:2]
    if llrs.device.type == "cpu":
        return decode_int8_plain(x, bg, zc, num_iters, b_tile, early_stop,
                                 with_sweeps=with_sweeps)
    hard, ok, sweeps = _launch(x, MODE_INT8, bg, zc, num_iters, DEFAULT_SCALING,
                               b_tile if early_stop else 0)
    cuda_build.LAUNCHES[KERNEL_INT8] += 1
    return (hard, ok, sweeps) if with_sweeps else (hard, ok)


def decode_int8_plain(llrs: torch.Tensor, bg: int, zc: int,
                      num_iters: int = DEFAULT_ITERS, b_tile: int = 32,
                      early_stop: bool = False, *, with_sweeps: bool = False):
    """K2's function in plain PyTorch (any device): ``_make_kernel_int8``'s
    int32 arithmetic sweep by sweep, ``_iterate_kernel``'s tile exit, hard
    bits ``L < 0`` and ``ok`` = check_parity of the hard bits."""
    x = _int8_input(llrs, bg, zc, b_tile)
    plan = get_decode_plan(bg, zc)
    b, dev = x.shape[0], x.device
    l = x.to(torch.int16)
    r_msgs = torch.zeros((b, plan.rows, plan.max_deg, zc), dtype=torch.int8,
                         device=dev)
    sweeps = torch.zeros((b,), dtype=torch.int32, device=dev)
    active = torch.arange(b, device=dev)
    for _ in range(num_iters):
        if active.numel() == b:
            _sweep_int8(l, r_msgs, bg, zc)
            l_a = l
        else:
            l_a, r_a = l[active], r_msgs[active]
            _sweep_int8(l_a, r_a, bg, zc)
            l[active], r_msgs[active] = l_a, r_a
        sweeps[active] += 1
        if not early_stop:
            continue
        ok_cb = check_parity((l_a < 0).to(torch.int8), bg, zc)
        tile_done = ok_cb.reshape(-1, b_tile).all(dim=1)
        active = active.reshape(-1, b_tile)[~tile_done].reshape(-1)
        if active.numel() == 0:
            break
    hard = (l < 0).to(torch.int8)
    ok = check_parity(hard, bg, zc)
    hard = hard[:, :plan.kb * zc]
    return (hard, ok, sweeps) if with_sweeps else (hard, ok)


def _sweep_int8(l: torch.Tensor, r_msgs: torch.Tensor, bg: int, zc: int
                ) -> None:
    """One K2 sweep over every check row, updating the int16 posterior L
    (B, cols*Zc) and the int8 messages R (B, rows, max_deg, Zc) in place."""
    pt = _plan_tensors(bg, zc, l.device)
    b = l.shape[0]
    for r, (idx, deg) in enumerate(zip(pt.row_idx, pt.row_deg)):
        t = (l[:, idx].reshape(b, deg, zc).to(torch.int32)
             - r_msgs[:, r, :deg].to(torch.int32))
        a = t.abs()
        m1, amin = a.min(dim=1, keepdim=True)       # first of equal minima
        iota = torch.arange(deg, device=l.device).reshape(1, deg, 1)
        first_min = iota == amin
        m2 = torch.where(first_min, 1 << 20, a).amin(dim=1, keepdim=True)
        mag = (torch.where(first_min, m2, m1) * 13) >> 4     # x 0.8125
        neg = (t < 0).sum(dim=1, keepdim=True, dtype=torch.int32) & 1
        flip = (neg ^ (t < 0).to(torch.int32)) != 0
        r_new = torch.clamp(torch.where(flip, -mag, mag), -INT8_CLAMP,
                            INT8_CLAMP)
        l[:, idx] = (t + r_new).reshape(b, -1).to(torch.int16)
        r_msgs[:, r, :deg] = r_new.to(torch.int8)
