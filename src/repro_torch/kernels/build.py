"""Build and bind the CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source for ``sm_90a`` into a shared library with a
plain C interface at first use, and ``ctypes`` loads it.  A library is
named after a hash of its source and the flags, so an edited source is
rebuilt and an unchanged one is built once per checkout.  The builds land
in ``build/`` at the repository root (git-ignored); :func:`build_all`
starts one ``nvcc`` per missing library, all at once.  Nothing here runs
at import: the CPU tests import every module.

Each launch goes through :func:`launch`, which raises when the C launcher
reports a CUDA error and counts successful launches per kernel in
:data:`LAUNCHES`.  Each kernel module also has a pure ``launch_spec``
that repeats its C launcher's arithmetic as a :class:`LaunchSpec` (grid,
threads, shared memory, each operand's tile): the static tile lint
(``analysis/tiles.py``) reads those and the sources, and launches
nothing.

Sources: ``wire_kernels.cu`` (the wire path), ``model_kernels.cu``
(serving: the SIMT and split-KV decode flash kernels, WKV6, the RG-LRU),
``attention_kernels.cu`` (the ``wgmma`` bf16 flash prefill) and
``fixture_kernels.cu``, the analyzer's deliberately mis-tiled copy
(``kernels/tile_copy.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
#: library (``csrc/<name>.cu``) -> kernel -> argument types of
#: ``launch_<kernel>``, the trailing stream included
LIBRARIES = {
    "wire_kernels": {
        # leaf descriptors, leaf count, 64-bit offsets
        "pack_int4": (_P, _I32, _I32, _P),
        "unpack_int4": (_P, _I32, _I32, _P),
        # leaf descriptors, leaf count, scal, pods, dtype, 64-bit offsets
        "dequant_merge_packed": (_P, _I32, _P, _I32, _I32, _I32, _P),
        "loss_weighted_update": (_P, _I32, _P, _I32, _I32, _I32, _P),
        "dequant_merge": (_P, _I32, _P, _I32, _I32, _I32, _P),
        "quantize_int8": (_P, _P, _P, _I64, _I64, _P),
        "dequantize_int8": (_P, _P, _P, _I64, _P),
    },
    "model_kernels": {
        # ..., dtype, B, Sq, Skv, H, K, D, Dv, causal, window, scale
        "flash_simt": (_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                       _I32, _I32, _I32, _I32, _I32, _F32, _P),
        # ..., dtype, B, Sq, Skv, H, K, D, Dv, groups, per_split, splits,
        # causal, window, scale
        "flash_decode": (_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                         _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
                         _I32, _I32, _F32, _P),
        "flash_decode_combine": (_P, _P, _P, _I32, _I32, _I32, _I32, _P),
        # ..., dtype, B, T, H, D, keys a block
        "wkv6": (_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                 _I32, _I32, _P),
        # ..., B, T, W, vec
        "rglru": (_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _P),
    },
    "attention_kernels": {
        # ..., B, Sq, Skv, H, K, D, Dv, causal, window, scale
        "flash_prefill": (_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                          _I32, _I32, _I32, _I32, _I32, _F32, _P),
    },
    "fixture_kernels": {
        "tile_copy": (_P, _P, _I32, _I32, _I32, _I32, _P),
    },
}
_LIBRARY_OF = {kern: lib_name for lib_name, kerns in LIBRARIES.items()
               for kern in kerns}

#: wrappers that count their own calls, one per call whichever of their
#: kernels it launched (``kernels/flash_attention.py``)
WRAPPERS = ("flash_attention",)

#: successful launches per kernel, and calls per wrapper, since the last
#: :func:`reset_launches`
LAUNCHES: Dict[str, int] = {name: 0 for name in (*_LIBRARY_OF, *WRAPPERS)}

#: ``kThreads`` of ``csrc/wire_kernels.cu``: every wire kernel's block
WIRE_THREADS = 256


def grid_for(n: int) -> int:
    """The wire kernels' grid for ``n`` work items (``grid_for`` of
    ``csrc/wire_kernels.cu``): one thread each, capped at 132 SMs x 16
    resident blocks, grid-stride loops covering the rest."""
    return min(-(-n // WIRE_THREADS), 132 * 16)


@dataclass(frozen=True)
class Operand:
    """One array of a launch, as the kernel indexes it: ``array`` its
    shape, ``tile`` the part of it one block touches in one step (a
    dimension equal to the array's is untiled), ``dtype`` its torch name.
    ``gather`` marks an operand read or written one value per block
    (the quantization scales): a gather, not a tile."""
    name: str
    array: Tuple[int, ...]
    tile: Tuple[int, ...]
    dtype: str
    gather: bool = False


@dataclass(frozen=True)
class LaunchSpec:
    """What a kernel's C launcher does for given shapes, without launching.

    ``kernel`` is the :data:`LAUNCHES` name, ``source`` its ``.cu`` file
    and ``function`` the ``__global__`` function there; ``grid``,
    ``threads`` and ``smem`` (dynamic shared bytes) are the launch, and
    ``static_smem`` the bytes of the function's own ``__shared__``
    arrays.
    ``accumulator`` names the variable the kernel sums in (None: it sums
    nothing), ``template`` binds the function's type parameters to dtype
    names, ``threads_of`` is the C expression of ``constexpr`` names the
    block size comes from, and ``constants`` the ``constexpr`` values the
    Python arithmetic here assumed; the lint holds all of these to the
    source."""
    kernel: str
    source: Path
    function: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int
    operands: Tuple[Operand, ...]
    accumulator: Optional[str] = None
    template: Mapping[str, str] = field(default_factory=dict)
    threads_of: Optional[str] = None
    constants: Mapping[str, int] = field(default_factory=dict)
    static_smem: int = 0


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
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
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha1(source(name).read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names: Optional[List[str]] = None) -> List[Path]:
    """Compile every missing library of ``names`` (default: all) with one
    ``nvcc`` each, started together; returns the libraries' paths."""
    global build_log
    names = list(LIBRARIES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source(name))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, out, tmp, proc))
        failed = []
        for name, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            build_log += f"--- {source(name).name}\n{log}"
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode})")
            else:
                os.replace(tmp, out)  # atomic: a concurrent builder sees
                #                       all or none
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n"
                               f"{build_log}")
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return [library_path(name) for name in names]


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first call)."""
    with _lock:
        if name not in _libs:
            path, = build_all([name])
            handle = ctypes.CDLL(str(path))
            for kern, argtypes in LIBRARIES[name].items():
                fn = getattr(handle, "launch_" + kern)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = handle
    return _libs[name]


_fns: Dict[str, ctypes._CFuncPtr] = {}


def launch(name: str, device: torch.device, *args) -> None:
    """Call ``launch_<name>`` on ``device``'s current stream; raise on a
    CUDA error, count the launch otherwise.  The host's cost counts in
    decode, where a call launches microseconds of work: the function is
    looked up once, and the device switched only when it is not current."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = getattr(lib(_LIBRARY_OF[name]), "launch_" + name)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1
