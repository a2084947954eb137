"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by nvcc for
Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` at first use, then
loaded with ctypes.  Importing this module compiles nothing: the CPU tests
import every module on hosts without nvcc.  The hash covers the source and
the flags, so an edited source is rebuilt.

``LAUNCHES`` counts kernel launches by kernel name: each wrapper adds one
where it launches its kernel, and nowhere else, so a run can show that the
main path went through the kernels.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
KERNELS = ("ldpc_layered",)

# --fmad=false: the f32 decoder mode must round every multiply and add
# separately to stay bit-equal to its plain PyTorch version.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: collections.Counter = collections.Counter()
BUILD_LOGS: dict[str, str] = {}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built; the
    compiler's report (registers, shared memory, spills) goes to
    ``BUILD_LOGS[name]``."""
    out = _library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={proc.returncode}):\n"
                           f"{BUILD_LOGS[name]}")
    os.replace(tmp, out)
    return out


def build_all(names=KERNELS) -> None:
    """Build several kernels at once, one nvcc process each."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(names)) as ex:
        for fut in [ex.submit(build, n) for n in names]:
            fut.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build(name)))
        return _libs[name]
