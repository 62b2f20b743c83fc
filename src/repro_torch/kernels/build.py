"""Build and bind the CUDA wire kernels (``csrc/wire_kernels.cu``).

``nvcc`` compiles the source for ``sm_90a`` into a shared library with a
plain C interface at first use, and ``ctypes`` loads it.  The library is
named after a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is built once per checkout.  The build lands
in ``build/`` at the repository root (git-ignored).  Nothing here runs at
import: the CPU tests import every module.

Each launch goes through :func:`launch`, which raises when the C launcher
reports a CUDA error and counts successful launches per kernel in
:data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "wire_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ARGTYPES = {
    "pack_int4": (_P, _P, _I64, _I64, _I64, _P),
    "unpack_int4": (_P, _P, _I64, _I64, _I64, _P),
    "dequant_merge_packed": (_P, _P, _P, _P, _P, _I32, _I64, _I64, _I64,
                             _I64, _P),
    "loss_weighted_update": (_P, _P, _P, _P, _I32, _I64, _P),
    "dequant_merge": (_P, _P, _P, _P, _P, _I32, _I64, _I64, _I64, _I64, _P),
    "quantize_int8": (_P, _P, _P, _I64, _I64, _P),
    "dequantize_int8": (_P, _P, _P, _I64, _P),
}

#: successful launches per kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {name: 0 for name in ARGTYPES}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log: str = ""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA wire kernels are built on "
                       "a machine with the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libwire_kernels_{digest}.so"


def build() -> Path:
    """Compile the source if its library is missing; returns its path."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in ARGTYPES.items():
                fn = getattr(handle, "launch_" + name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call ``launch_<name>`` on ``device``'s current stream; raise on a
    CUDA error, count the launch otherwise."""
    fn = getattr(lib(), "launch_" + name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1
