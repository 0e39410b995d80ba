"""Build and load the hand-written CUDA kernels (the ring kernels K1-K4 and
flash attention K6).

The ``*.cu`` sources beside the kernel packages have a plain C interface.
At first use, :func:`library` compiles each source with ``nvcc`` for
``sm_90a`` (all sources at once, one process each), links the objects into
one shared library under ``kernels/_build/<hash>/`` and loads it with
``ctypes``.  The hash covers the sources and flags, so an edited source
rebuilds and an unchanged one is loaded as built.  Nothing here runs at
import time: this module imports on machines without ``nvcc`` or a GPU.

:func:`launch` is the one call path from a wrapper into a kernel: it
refuses extents past 32 bits, takes PyTorch's current stream and raises on
any error ``cudaGetLastError`` reports right after the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["library", "launch", "row_bytes", "word_bytes", "check_cuda",
           "lane_vec", "BUILD_DIR", "SOURCES"]

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"
SOURCES = (
    _HERE / "queue_steal" / "ring_gather.cu",
    _HERE / "queue_push" / "ring_push.cu",
    _HERE / "queue_transfer" / "ring_transfer.cu",
    _HERE / "flash_attention" / "flash_attention.cu",
)
HEADERS = (_HERE / "ring_rows.cuh",)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    # name: argument types after the C prototypes in the .cu sources
    "rk_ring_gather": (_P, _P, _P, _P, _I, _I, _I, _L, _I, _P),
    "rk_ring_scatter": (_P, _P, _P, _P, _I, _I, _I, _L, _I, _P),
    "rk_ring_slice": (_P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _P),
    "rk_ring_transfer": (_P, _P, _P, _P, _P, _I, _I, _L, _I, _L, _I, _P),
    "fa_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                           _I, _I, _I, _I, _F, _P),
}

_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in SOURCES + HEADERS:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (one ``nvcc`` each, started together) and link
    them into one shared library; returns its path.  Reuses an existing
    build of the same sources and flags."""
    out = BUILD_DIR / _digest() / "librepro_kernels.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failures = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{log}")
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-shared", "-o", str(lib),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(lib, out)  # atomic: a concurrent build sees all or none
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rk_error_string.argtypes = (ctypes.c_int,)
        lib.rk_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch(name: str, *args, device: torch.device) -> None:
    """Launch kernel ``name`` on PyTorch's current stream of ``device``;
    raise ``ValueError`` for an extent the kernel's 32-bit ``int``
    arguments cannot hold, and ``RuntimeError`` if the launch was
    refused."""
    for arg, kind in zip(args, _SIGNATURES[name]):
        if kind is _I and not 0 <= arg < 2 ** 31:
            raise ValueError(f"{name}: extent {arg} does not fit the "
                             f"kernel's 32-bit int arguments")
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.rk_error_string(err).decode()} ({err})")


def row_bytes(t: torch.Tensor) -> int:
    """Bytes of one row of a ``(lanes, rows, ...)`` tensor."""
    return math.prod(t.shape[2:]) * t.element_size()


def word_bytes(row_bytes: int, *tensors: torch.Tensor) -> int:
    """The widest word (4, 2 or 1 bytes) that divides a row and aligns every
    tensor's base address."""
    for w in (4, 2, 1):
        if row_bytes % w == 0 and all(t.data_ptr() % w == 0 for t in tensors):
            return w
    return 1


def check_cuda(*tensors: torch.Tensor) -> torch.device:
    """Refuse what the kernels do not take: every tensor contiguous and on
    one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels need contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels run on CUDA tensors, got {dev}")
    return dev


def lane_vec(x: torch.Tensor, lanes: int, name: str) -> torch.Tensor:
    """Validate a per-lane int32 cursor vector of shape ``(lanes,)``."""
    if x.dtype != torch.int32 or tuple(x.shape) != (lanes,):
        raise ValueError(f"{name} must be int32 of shape ({lanes},), got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x.contiguous()
