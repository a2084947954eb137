"""PDSCH coding: the two CUDA kernels of ``csrc/pdsch_code.cu`` and their
plain chain.

``encode`` turns (B_tb, A) payload bits into the rate-matched bits of a run
of their codeblocks (TB CRC, segmentation and CRC24B, filler bits, LDPC
encode, rate match); ``modulate`` scrambles (rows, G) bits with each row's
Gold sequence and maps them to complex64 symbols.  A CUDA tensor launches
the kernel (``pdsch_encode``, ``pdsch_modulate``; each launch counted in
``cuda_build.LAUNCHES`` under that name) or raises; a CPU tensor runs the
plain chain (``segmenter``, ``encoder``, ``rate_match``, ``sequences``,
``modulation``), which the CPU tests and the on-card comparison use.

The kernels read host-built tables, built here once per plan and held to
the plain chain by the CPU tests: the base graph's edges and the core
parities' solve as rotation terms (``encode_tables``), the CRCs' remainder
word per bit position (``crc_words``), the rate matcher's index vector as
bit addresses in the packed codeword (``rm_addresses``), the packed Gold
x1 row and x2 basis (``gold_words``) and the symbol table
(``symbol_table``).  Bits pack into 32-bit words least significant bit
first: bit i of a vector is bit i % 32 of word i // 32.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import cuda_build
from ..utils.tracing import cached_build
from . import crc, modulation, sequences
from .ldpc import encoder, rate_match, segmenter
from .ldpc.graph import get_graph

LIBRARY = "pdsch_code"
KERNEL_ENCODE = "pdsch_encode"
KERNEL_MODULATE = "pdsch_modulate"
CRC_LEN = {"crc16": 16, "crc24a": 24}


def _pack_words(bits: np.ndarray) -> np.ndarray:
    """(..., n) {0,1} -> (..., ceil(n / 32)) uint32, bit i in word i // 32."""
    packed = np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")
    pad = -packed.shape[-1] % 4
    packed = np.pad(packed, [(0, 0)] * (packed.ndim - 1) + [(0, pad)])
    return np.ascontiguousarray(packed).view("<u4")


@cached_build
def encode_tables(bg: int, zc: int) -> np.ndarray:
    """int32 table of the encoder kernel: row_start (rows + 1), the edges
    row by row as col << 16 | shift, core_start (5), and the core solve's
    terms as row << 16 | shift.

    The four core parities are p = A^-1 s, s the core rows' sums over the
    message columns.  A's blocks are circulant, so A^-1's are too: block
    (j, i) is the XOR of the rotations by the set bits of its first row,
    and core column j's terms are the (i, rotation) pairs of its blocks."""
    g = get_graph(bg, zc)
    inv = encoder.get_encode_plan(bg, zc, torch.device("cpu")).core_inv_t.T
    inv = inv.numpy().astype(np.uint8)
    z = np.arange(zc)
    terms, core_start = [], [0]
    for j in range(4):
        for i in range(4):
            blk = inv[j * zc:(j + 1) * zc, i * zc:(i + 1) * zc]
            shifts = np.nonzero(blk[0])[0]
            if blk.sum() != len(shifts) * zc or not all(
                    blk[z, (z + s) % zc].all() for s in shifts):
                raise ValueError(f"BG{bg} Zc={zc}: core inverse block ({j}, {i}) "
                                 "is not circulant")
            terms += [(i << 16) | int(s) for s in shifts]
        core_start.append(len(terms))
    row_start = np.concatenate([[0], np.cumsum(np.bincount(g.edge_row,
                                                           minlength=g.rows))])
    edges = (g.edge_col.astype(np.int64) << 16) | g.edge_shift
    return np.concatenate([row_start, edges, core_start, terms]).astype(np.int32)


@cached_build
def crc_words(name: str, n: int) -> np.ndarray:
    """(n,) uint32: bit position i's remainder x^(n-1-i+L) mod g of the CRC
    ``name`` over n message bits, the first CRC bit in bit L-1.  The CRC of
    a message is the XOR of the words of its set bits."""
    t = crc.remainder_table(name, n).astype(np.uint32)
    weights = np.uint32(1) << np.arange(t.shape[1] - 1, -1, -1, dtype=np.uint32)
    return np.bitwise_or.reduce(t * weights, axis=1).astype(np.uint32)


@cached_build
def rm_addresses(plan: rate_match.RateMatchPlan) -> tuple[np.ndarray, int]:
    """(E,) uint16 bit address of each rate-matched bit in the kernel's
    packed codeword (column c's Zc bits in words c * nw ..., nw =
    ceil(Zc / 32)), and the parity rows the kernel has to compute: the core
    four and every extension row whose column the bits reach."""
    g = get_graph(plan.bg, plan.zc)
    nw = -(-plan.zc // 32)
    col, z = np.divmod(plan.select_idx + 2 * plan.zc, plan.zc)
    addr = col * (32 * nw) + z
    rows_used = max(4, int(col.max()) - g.kb + 1)
    return addr.astype(np.uint16), rows_used


@cached_build
def gold_words(length: int) -> tuple[np.ndarray, np.ndarray]:
    """``sequences.gold_tables(length)`` packed: x1 (nw,) and the x2 basis
    (31, nw) uint32.  Word w of c_init's sequence is x1[w] XOR the basis
    rows of c_init's set bits."""
    x1, basis = sequences.gold_tables(length)
    return _pack_words(x1), _pack_words(basis)


@cached_build
def symbol_table(qm: int) -> np.ndarray:
    """(2^qm,) complex64: ``modulation.modulate`` of the bit pattern whose
    bit j is the symbol's j-th bit."""
    idx = np.arange(1 << qm)
    bits = (idx[:, None] >> np.arange(qm)) & 1
    name = modulation.NAME_BY_QM[qm]
    return modulation.modulate(torch.as_tensor(bits.reshape(-1), dtype=torch.int8),
                               name).numpy()


@dataclasses.dataclass(frozen=True, eq=False)
class _EncodePlan:
    tables: torch.Tensor
    crc_tb: torch.Tensor
    crc_cb: torch.Tensor | None
    rm_addr: torch.Tensor
    rows_used: int
    n_edges: int
    n_core: int


@cached_build
def _encode_plan(seg: segmenter.SegmentPlan, rm: rate_match.RateMatchPlan,
                 device: torch.device) -> _EncodePlan:
    g = get_graph(seg.bg, seg.zc)
    addr, rows_used = rm_addresses(rm)

    def on(x):
        return torch.as_tensor(x.view(np.int32) if x.dtype == np.uint32 else
                               x.view(np.int16) if x.dtype == np.uint16 else x,
                               device=device)

    p = seg.k_prime - (24 if seg.cb_crc else 0)
    tables = encode_tables(seg.bg, seg.zc)
    return _EncodePlan(tables=on(tables),
                       crc_tb=on(crc_words(seg.tb_crc, seg.a)),
                       crc_cb=on(crc_words("crc24b", p)) if seg.cb_crc else None,
                       rm_addr=on(addr), rows_used=rows_used,
                       n_edges=g.num_edges,
                       n_core=len(tables) - (g.rows + 1 + g.num_edges + 5))


@cached_build
def gold_on(length: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``gold_words(length)`` on ``device`` as int32 tensors (x1, basis)."""
    x1, basis = gold_words(length)
    return (torch.as_tensor(x1.view(np.int32), device=device),
            torch.as_tensor(basis.view(np.int32), device=device))


@cached_build
def _modulate_tables(length: int, qm: int, device: torch.device):
    return (*gold_on(length, device),
            torch.as_tensor(symbol_table(qm), device=device))


@cached_build
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(LIBRARY)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pdsch_encode.argtypes = [ptr] * 6 + [i32] * 14 + [ptr]
    lib.pdsch_encode.restype = i32
    lib.pdsch_modulate.argtypes = [ptr] * 6 + [i32] * 3 + [ptr]
    lib.pdsch_modulate.restype = i32
    return lib


def _check_device(x: torch.Tensor, kernel: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {x.device}")


def encode(payload: torch.Tensor, seg: segmenter.SegmentPlan,
           rm: rate_match.RateMatchPlan, cbs: slice) -> torch.Tensor:
    """(B_tb, A) payload bits -> (n, E) int8 rate-matched bits of codeblocks
    ``cbs`` (a slice of the B_tb * C codeblocks, codeblock i of TB t being
    t * C + i): the kernel on a CUDA tensor, the plain chain on a CPU one."""
    if payload.device.type == "cpu":
        blocks = segmenter.segment_tb(payload, seg)[cbs]
        return rate_match.rate_match(encoder.encode(blocks, seg.bg, seg.zc), rm)
    _check_device(payload, KERNEL_ENCODE)
    b_tb = payload.shape[0]
    lo, hi, step = cbs.indices(b_tb * seg.c)
    if payload.ndim != 2 or payload.shape[1] != seg.a:
        raise ValueError(f"payload must be (B_tb, {seg.a}), got {tuple(payload.shape)}")
    if step != 1:
        raise ValueError(f"codeblocks must be a run, got step {step}")
    if (rm.bg, rm.zc, rm.k_prime) != (seg.bg, seg.zc, seg.k_prime) or rm.e not in seg.e:
        raise ValueError("the rate-match plan is not the segment plan's")
    dev = payload.device
    n = max(hi - lo, 0)
    out = torch.empty((n, rm.e), dtype=torch.int8, device=dev)
    if n == 0:
        return out
    payload = payload.to(torch.int8).contiguous()
    plan = _encode_plan(seg, rm, dev)
    g = get_graph(seg.bg, seg.zc)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.pdsch_encode(
            payload.data_ptr(), out.data_ptr(), plan.tables.data_ptr(),
            plan.crc_tb.data_ptr(),
            0 if plan.crc_cb is None else plan.crc_cb.data_ptr(),
            plan.rm_addr.data_ptr(), n, lo, seg.a, seg.c,
            seg.k_prime - (24 if seg.cb_crc else 0), CRC_LEN[seg.tb_crc],
            int(seg.cb_crc), seg.zc, g.kb, g.rows, plan.rows_used,
            plan.n_edges, plan.n_core, rm.e,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"{KERNEL_ENCODE} launch failed: CUDA error {rc}")
    cuda_build.LAUNCHES[KERNEL_ENCODE] += 1
    return out


def modulate(bits: torch.Tensor, c_init: torch.Tensor,
             modulation_name: str) -> torch.Tensor:
    """(rows, G) {0,1} bits scrambled by the Gold sequences of the rows'
    ``c_init`` (rows,) and mapped to (rows, G / Qm) complex64 symbols: the
    kernel on a CUDA tensor, ``scramble_bits`` then ``modulate`` on a CPU
    one."""
    if bits.device.type == "cpu":
        return modulation.modulate(sequences.scramble_bits(bits, c_init),
                                   modulation_name)
    _check_device(bits, KERNEL_MODULATE)
    qm = modulation.QM[modulation_name]
    if bits.ndim != 2 or bits.shape[1] % qm:
        raise ValueError(f"bits must be (rows, G) with G a multiple of Qm={qm}, "
                         f"got {tuple(bits.shape)}")
    rows, g = bits.shape
    if tuple(c_init.shape) != (rows,):
        raise ValueError(f"c_init must be ({rows},), got {tuple(c_init.shape)}")
    dev = bits.device
    out = torch.empty((rows, g // qm), dtype=torch.complex64, device=dev)
    if rows == 0:
        return out
    bits = bits.to(torch.int8).contiguous()
    c_init = c_init.to(device=dev, dtype=torch.int64).contiguous()
    x1, basis, table = _modulate_tables(g, qm, dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.pdsch_modulate(
            bits.data_ptr(), c_init.data_ptr(), x1.data_ptr(), basis.data_ptr(),
            table.data_ptr(), out.data_ptr(), rows, g, qm,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"{KERNEL_MODULATE} launch failed: CUDA error {rc}")
    cuda_build.LAUNCHES[KERNEL_MODULATE] += 1
    return out
