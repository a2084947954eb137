"""O-RAN fronthaul U-Plane serdes: eCPRI IQ-data frames, section type 1.

Port of ``srsran_edgeric_5g_tpu/runtime/ofh.py``: a ctypes binding over
native/ofh/ofh_uplane.cpp (both packages bind the same host C++ library,
built by ``make -C native`` at first use), the byte-exact counterpart of
the reference's ecpri_packet_builder_impl +
ofh_uplane_message_builder_static_compression_impl.

``frame_dl_slot`` compresses a DL slot grid with ``ops.ofh_compression``
on the grid's device and copies only the mantissas and exponents to the
host, where they are packed and framed (one eCPRI message per OFDM
symbol); ``deframe_dl_slot`` parses and unpacks on the host and
decompresses on the device.  The Ethernet/DPDK NIC layer is out of scope.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
import subprocess

import numpy as np
import torch

from ..device import resolve_device
from ..ops import ofh_compression as comp

_NATIVE = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB = _NATIVE / "build" / "libofhuplane.so"
_lib = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        if not _LIB.exists():
            subprocess.run(["make", "-C", str(_NATIVE)], check=True,
                           capture_output=True)
        l = ctypes.CDLL(str(_LIB))
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        l.ofh_uplane_frame_size.restype = ctypes.c_uint
        l.ofh_uplane_frame_size.argtypes = [ctypes.c_uint] * 3
        l.ofh_uplane_build_dl.restype = ctypes.c_uint
        l.ofh_uplane_build_dl.argtypes = (
            [u8p, ctypes.c_uint16, ctypes.c_uint16] + [ctypes.c_uint] * 7
            + [u8p, u8p])
        l.ofh_uplane_parse.restype = ctypes.c_int
        l.ofh_uplane_parse.argtypes = (
            [u8p, ctypes.c_uint,
             ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint16)]
            + [ctypes.POINTER(ctypes.c_uint)] * 6
            + [ctypes.c_uint, ctypes.c_uint, u8p, u8p])
        l.ofh_eth_header_size.restype = ctypes.c_uint
        l.ofh_eth_header_size.argtypes = []
        l.ofh_eth_build.restype = ctypes.c_uint
        l.ofh_eth_build.argtypes = [u8p, u8p, u8p, ctypes.c_uint16,
                                    ctypes.c_uint16, u8p, ctypes.c_uint]
        l.ofh_eth_parse.restype = ctypes.c_int
        l.ofh_eth_parse.argtypes = [u8p, ctypes.c_uint, u8p, u8p,
                                    ctypes.POINTER(ctypes.c_uint16),
                                    ctypes.POINTER(ctypes.c_uint16)]
        _lib = l
    return _lib


@dataclasses.dataclass(frozen=True)
class UplaneHeader:
    pc_id: int
    seq_id: int
    sfn: int
    subframe: int
    slot: int
    symbol: int
    start_prb: int
    nof_prb: int


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def build_dl_frame(pc_id: int, seq_id: int, sfn: int, subframe: int,
                   slot: int, symbol: int, start_prb: int, width: int,
                   exponents: np.ndarray | None,
                   packed: np.ndarray) -> bytes:
    """One symbol's compressed PRBs -> one eCPRI U-Plane frame.

    ``packed`` is (nof_prb, ceil(24*width/8)) uint8 (``pack_prbs``);
    ``exponents`` is (nof_prb,) uint8, or None for the 'none' compression
    type."""
    nof_prb = packed.shape[0]
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    if packed.shape[1] != (24 * width + 7) // 8:
        raise ValueError(f"packed PRBs of {packed.shape[1]} bytes at width {width}")
    exp = (np.ascontiguousarray(exponents, dtype=np.uint8)
           if exponents is not None else None)
    if exp is not None and exp.shape != (nof_prb,):
        raise ValueError(f"{exp.shape} exponents for {nof_prb} PRBs")
    size = lib().ofh_uplane_frame_size(nof_prb, width, 1 if exp is not None else 0)
    out = np.empty(size, np.uint8)
    n = lib().ofh_uplane_build_dl(
        _u8(out), pc_id, seq_id, sfn, subframe, slot, symbol, start_prb,
        nof_prb, width, _u8(exp) if exp is not None else None, _u8(packed))
    if n != size:
        raise RuntimeError(f"ofh_uplane_build_dl wrote {n} of {size} bytes")
    return out.tobytes()


def parse_frame(frame: bytes, width: int, with_exponent: bool = True
                ) -> tuple[UplaneHeader, np.ndarray | None, np.ndarray]:
    """Inverse of build_dl_frame: -> (header, exponents, packed)."""
    buf = np.frombuffer(frame, np.uint8)
    prb_payload = (24 * width + 7) // 8
    prb_bytes = prb_payload + (1 if with_exponent else 0)
    max_prb = max(0, (len(frame) - 16) // prb_bytes)
    exps = np.zeros(max_prb, np.uint8)
    packed = np.zeros((max_prb, prb_payload), np.uint8)
    u16, u = ctypes.c_uint16, ctypes.c_uint
    pc, seq = u16(), u16()
    sfn, sub, slot, sym, sprb, nprb = u(), u(), u(), u(), u(), u()
    rc = lib().ofh_uplane_parse(
        _u8(buf), len(frame), ctypes.byref(pc), ctypes.byref(seq),
        ctypes.byref(sfn), ctypes.byref(sub), ctypes.byref(slot),
        ctypes.byref(sym), ctypes.byref(sprb), ctypes.byref(nprb),
        width, 1 if with_exponent else 0, _u8(exps), _u8(packed))
    if rc != 0:
        raise ValueError(f"U-Plane frame parse failed: {rc}")
    n = nprb.value
    hdr = UplaneHeader(pc.value, seq.value, sfn.value, sub.value, slot.value,
                       sym.value, sprb.value, n)
    return hdr, (exps[:n] if with_exponent else None), packed[:n]


ECPRI_ETH_TYPE = 0xAEFE  # include/srsran/ofh/ethernet/ethernet_properties.h:31


def build_eth_frame(dst_mac: bytes, src_mac: bytes, tci: int,
                    payload: bytes, eth_type: int = ECPRI_ETH_TYPE) -> bytes:
    """VLAN-tagged Ethernet frame around one eCPRI message — the wire
    format of vlan_ethernet_frame_builder_impl.cpp:36-57, zero-padded to
    the 64-byte minimum."""
    if len(dst_mac) != 6 or len(src_mac) != 6:
        raise ValueError("MAC addresses are 6 bytes")
    pl = np.frombuffer(payload, np.uint8)
    out = np.empty(max(18 + len(payload), 64), np.uint8)
    n = lib().ofh_eth_build(
        _u8(out), _u8(np.frombuffer(dst_mac, np.uint8)),
        _u8(np.frombuffer(src_mac, np.uint8)), tci, eth_type,
        _u8(pl), len(pl))
    return out[:n].tobytes()


def parse_eth_frame(frame: bytes
                    ) -> tuple[bytes, bytes, int | None, int, bytes]:
    """-> (dst_mac, src_mac, tci or None, eth_type, payload).  Handles both
    the tagged loopback form and the NIC-stripped form
    (vlan_ethernet_frame_decoder_impl.cpp:31-52); frames under the 64-byte
    minimum are rejected as the reference drops them."""
    buf = np.frombuffer(frame, np.uint8)
    dst = np.zeros(6, np.uint8)
    src = np.zeros(6, np.uint8)
    tci = ctypes.c_uint16()
    et = ctypes.c_uint16()
    off = lib().ofh_eth_parse(_u8(buf), len(frame), _u8(dst), _u8(src),
                              ctypes.byref(tci), ctypes.byref(et))
    if off <= 0:
        raise ValueError(f"Ethernet frame parse failed: {off}")
    return (dst.tobytes(), src.tobytes(),
            None if tci.value == 0xFFFF else tci.value, et.value,
            frame[off:])


def frame_dl_slot(grid_iq, pc_id: int, sfn: int, subframe: int, slot: int,
                  width: int = 9, iq_scaling: float = 1.0, seq0: int = 0,
                  device: str | torch.device = "cuda") -> list[bytes]:
    """Compress + frame a whole DL slot grid (nsymb, nsubc complex) into one
    eCPRI U-Plane message per OFDM symbol; the compression runs on
    ``device``."""
    grid = torch.as_tensor(grid_iq, device=resolve_device(device))
    nsymb, nsubc = grid.shape
    if nsubc % comp.NOF_SUBC_PER_PRB:
        raise ValueError(f"{nsubc} subcarriers is not a whole number of PRBs")
    mant, exp = comp.bfp_compress(grid, width, iq_scaling)
    mant, exp = mant.cpu().numpy(), exp.cpu().numpy().astype(np.uint8)
    return [build_dl_frame(pc_id, (seq0 + l) & 0xFFFF, sfn, subframe, slot, l,
                           0, width, exp[l], comp.pack_prbs(mant[l], width))
            for l in range(nsymb)]


def deframe_dl_slot(frames: list[bytes], width: int = 9,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """Inverse of frame_dl_slot -> (nsymb, nsubc) complex64 grid on
    ``device`` (rows in symbol order)."""
    dev = resolve_device(device)
    parsed = sorted((parse_frame(f, width) for f in frames),
                    key=lambda p: p[0].symbol)
    mant = np.stack([comp.unpack_prbs(packed, width) for _, _, packed in parsed])
    exps = np.stack([e.astype(np.int32) for _, e, _ in parsed])
    return comp.bfp_decompress(torch.as_tensor(mant, device=dev),
                               torch.as_tensor(exps, device=dev))
