"""ctypes binding for the native IQ bridge (native/iqbridge).

Copy of ``srsran_edgeric_5g_tpu/runtime/iqbridge.py``; both packages bind
the same host C++ library.  Counterpart of the reference's lib/radio/zmq
sample transport: a REP server that feeds TX samples to GNU Radio / srsue on
request, a REQ client that pulls RX samples, SPSC rings toward the PHY
process, and raw-cf32 capture/replay for the parity harness.

The shared library is built on demand with `make -C native` (g++ only; libzmq
is dlopen'd from the system .so.5).
"""

from __future__ import annotations

import ctypes
import errno
import os
import pathlib
import subprocess
import time

import numpy as np

_NATIVE = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB = _NATIVE / "build" / "libiqbridge.so"


def _load() -> ctypes.CDLL:
    if not _LIB.exists():
        subprocess.run(["make", "-C", str(_NATIVE)], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(str(_LIB))
    lib.iq_ring_create.restype = ctypes.c_void_p
    lib.iq_ring_create.argtypes = [ctypes.c_size_t]
    lib.iq_ring_destroy.argtypes = [ctypes.c_void_p]
    for fn in (lib.iq_ring_write, lib.iq_ring_read):
        fn.restype = ctypes.c_size_t
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                       ctypes.c_size_t]
    lib.iq_ring_size.restype = ctypes.c_size_t
    lib.iq_ring_size.argtypes = [ctypes.c_void_p]

    lib.iq_tx_server_start.restype = ctypes.c_void_p
    lib.iq_tx_server_start.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_uint]
    lib.iq_tx_server_push.restype = ctypes.c_size_t
    lib.iq_tx_server_push.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_size_t]
    lib.iq_tx_server_served.restype = ctypes.c_uint64
    lib.iq_tx_server_served.argtypes = [ctypes.c_void_p]
    lib.iq_tx_server_stop.argtypes = [ctypes.c_void_p]

    lib.iq_rx_client_start.restype = ctypes.c_void_p
    lib.iq_rx_client_start.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_uint]
    lib.iq_rx_client_pull.restype = ctypes.c_size_t
    lib.iq_rx_client_pull.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_size_t]
    lib.iq_rx_client_received.restype = ctypes.c_uint64
    lib.iq_rx_client_received.argtypes = [ctypes.c_void_p]
    lib.iq_rx_client_stop.argtypes = [ctypes.c_void_p]

    for fn in (lib.iq_file_write, lib.iq_file_read):
        fn.restype = ctypes.c_size_t
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                       ctypes.c_size_t]
    return lib


_lib = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


def _require_zmq() -> None:
    """The native server and client dlopen libzmq when they start and abort
    the process where it is missing; raise an exception here instead."""
    for name in ("libzmq.so.5", "libzmq.so"):
        try:
            ctypes.CDLL(name, mode=ctypes.RTLD_GLOBAL)
            return
        except OSError:
            pass
    raise RuntimeError("libzmq not found (libzmq.so.5 or libzmq.so): the ZMQ "
                       "IQ bridge needs the system's libzmq")


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _as_cf32(samples: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(samples, dtype=np.complex64)


class IqRing:
    """SPSC ring of complex64 samples."""

    def __init__(self, capacity: int):
        self._h = lib().iq_ring_create(capacity)

    def write(self, samples: np.ndarray) -> int:
        s = _as_cf32(samples)
        return lib().iq_ring_write(self._h, _fptr(s.view(np.float32)), len(s))

    def read(self, n: int) -> np.ndarray:
        out = np.empty(n, np.complex64)
        got = lib().iq_ring_read(self._h, _fptr(out.view(np.float32)), n)
        return out[:got]

    def __len__(self) -> int:
        return lib().iq_ring_size(self._h)

    def close(self):
        if self._h:
            lib().iq_ring_destroy(self._h)
            self._h = None


_BIND_TIMEOUT_S = 2.0


def _listen_sockets(port: int) -> set[str] | None:
    """The TCP sockets of this process listening on ``port`` (as
    "socket:[inode]"); None where /proc does not say (not Linux)."""
    try:
        fds = os.listdir("/proc/self/fd")
    except OSError:
        return None
    own = set()
    for fd in fds:
        try:
            own.add(os.readlink(f"/proc/self/fd/{fd}"))
        except OSError:          # closed since listed (listdir's own fd)
            pass
    found = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            # local_address is HEXIP:HEXPORT, state 0A is LISTEN, then the inode.
            cols = row.split()
            sock = f"socket:[{cols[9]}]"
            if int(cols[1].rsplit(":", 1)[1], 16) == port and cols[3] == "0A" \
                    and sock in own:
                found.add(sock)
    return found


class IqTxServer:
    """ZMQ REP sample server (the gNB 'radio TX' end of the zmq loopback).

    The native server binds in its own thread and does not report a failed
    bind; for a ``tcp://host:port`` address the constructor waits (up to
    ``_BIND_TIMEOUT_S``) until a new socket of this process listens on the
    port, and raises OSError(EADDRINUSE) if none does, instead of serving
    nothing while the client reads another server."""

    def __init__(self, address: str, ring_capacity: int = 1 << 22,
                 chunk: int = 11520):
        _require_zmq()
        port = int(address.rsplit(":", 1)[1]) if address.startswith("tcp://") else None
        before = None if port is None else _listen_sockets(port)
        self._h = lib().iq_tx_server_start(address.encode(), ring_capacity, chunk)
        if before is None:
            return
        deadline = time.monotonic() + _BIND_TIMEOUT_S
        while not _listen_sockets(port) - before:
            if time.monotonic() > deadline:
                self.stop()
                raise OSError(errno.EADDRINUSE, f"the IQ bridge could not bind {address}")
            time.sleep(0.01)

    def push(self, samples: np.ndarray) -> int:
        s = _as_cf32(samples)
        return lib().iq_tx_server_push(self._h, _fptr(s.view(np.float32)), len(s))

    @property
    def served(self) -> int:
        return lib().iq_tx_server_served(self._h)

    def stop(self):
        if self._h:
            lib().iq_tx_server_stop(self._h)
            self._h = None


class IqRxClient:
    """ZMQ REQ sample puller (the gNB 'radio RX' end)."""

    def __init__(self, address: str, ring_capacity: int = 1 << 22,
                 chunk: int = 11520):
        _require_zmq()
        self._h = lib().iq_rx_client_start(address.encode(), ring_capacity, chunk)

    def pull(self, n: int) -> np.ndarray:
        out = np.empty(n, np.complex64)
        got = lib().iq_rx_client_pull(self._h, _fptr(out.view(np.float32)), n)
        return out[:got]

    @property
    def received(self) -> int:
        return lib().iq_rx_client_received(self._h)

    def stop(self):
        if self._h:
            lib().iq_rx_client_stop(self._h)
            self._h = None


def iq_file_write(path: str, samples: np.ndarray) -> int:
    s = _as_cf32(samples)
    return lib().iq_file_write(str(path).encode(), _fptr(s.view(np.float32)), len(s))


def iq_file_read(path: str, max_samples: int) -> np.ndarray:
    out = np.empty(max_samples, np.complex64)
    got = lib().iq_file_read(str(path).encode(), _fptr(out.view(np.float32)),
                             max_samples)
    return out[:got]
