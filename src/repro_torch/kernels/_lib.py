"""Build and load the hand-written CUDA kernels (the ring kernels K1-K4,
DD layer expansion K5 and the fused DD explore built on it, flash
attention K6 and the SSD scan K7 — each of K6 and K7 a tensor-core kernel
for bfloat16 and a SIMT kernel for float32).

The ``*.cu`` sources beside the kernel packages have a plain C interface.
At first use, :func:`library` compiles each source with ``nvcc`` for
``sm_90a`` (all sources at once, one process each), links the objects into
one shared library under ``kernels/_build/<hash>/`` and loads it with
``ctypes``.  The hash covers the sources and flags, so an edited source
rebuilds and an unchanged one is loaded as built.  Nothing here runs at
import time: this module imports on machines without ``nvcc`` or a GPU.

:func:`launch` is the one call path from a wrapper into a kernel: it
refuses extents past 32 bits, takes PyTorch's current stream, raises on
any error ``cudaGetLastError`` reports right after the launch, and counts
the launch on the wrapper it is given (``<wrapper>.launches``).  While a
thread captures a CUDA graph (:func:`recording`) its launches run no
kernel: they are noted instead, and :func:`replayed` counts them at each
replay of the graph, so a counter means launches on the card.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["library", "launch", "counted", "recording", "replayed",
           "row_bytes", "check_cuda", "lane_vec", "ring_trees",
           "ring_extents_fit", "RingTree", "MAX_LEAVES", "BUILD_DIR",
           "SOURCES"]

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"
SOURCES = (
    _HERE / "queue_steal" / "ring_gather.cu",
    _HERE / "queue_push" / "ring_push.cu",
    _HERE / "queue_push" / "ring_slice.cu",
    _HERE / "queue_transfer" / "ring_transfer.cu",
    _HERE / "flash_attention" / "flash_attention.cu",
    _HERE / "flash_attention" / "flash_attention_wgmma.cu",
    _HERE / "ssd_scan" / "ssd_scan.cu",
    _HERE / "ssd_scan" / "ssd_scan_wgmma.cu",
    _HERE / "dd_expand" / "expand.cu",
    _HERE / "dd_expand" / "explore.cu",
)
HEADERS = (_HERE / "ring_copy.cuh", _HERE / "hopper.cuh")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

MAX_LEAVES = 8  # payload leaves per launch of K1-K4 (ring_copy.cuh)


class RingLeaf(ctypes.Structure):
    """``ringcopy::RingLeaf``: one payload leaf of a K1-K4 launch."""
    _fields_ = [("src", _P), ("dst", _P), ("row_bytes", _I)]


class RingTree(ctypes.Structure):
    """``ringcopy::RingTree``, passed by value: up to ``MAX_LEAVES``
    leaves, so a launch needs no device array of pointers."""
    _fields_ = [("leaf", RingLeaf * MAX_LEAVES), ("count", _I)]


_SIGNATURES = {
    # name: argument types after the C prototypes in the .cu sources
    "rk_ring_gather": (RingTree, _P, _P, _I, _I, _I, _P),
    "rk_ring_scatter": (RingTree, _P, _P, _I, _I, _I, _P),
    "rk_ring_slice": (RingTree, _P, _P, _P, _I, _I, _I, _P),
    "rk_ring_transfer": (RingTree, _P, _P, _P, _I, _I, _I, _I, _P),
    "fa_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                           _I, _I, _I, _I, _F, _P),
    "fa_flash_attention_wgmma": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                 _I, _I, _I, _I, _F, _P),
    "ss_ssd_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    _I, _P),
    "ss_ssd_scan_wgmma": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, _I, _P),
    "dd_expand": (_P, _P, _P, _L, _P, _L, _P, _P, _I, _I, _P),
    "dd_explore": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                   _P, _P),
}

_LIB = None
# per thread: the launches a CUDA graph's capture on it has noted, or None
_capture = threading.local()


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


def launch(name: str, *args, device: torch.device, counter=None) -> None:
    """Launch kernel ``name`` on PyTorch's current stream of ``device``
    and count it on ``counter``, the wrapper (:func:`counted`); raise
    ``ValueError`` for an extent the kernel's 32-bit ``int`` arguments
    cannot hold, and ``RuntimeError`` if the launch was refused."""
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
    if counter is not None:
        counted(counter)


def counted(counter) -> None:
    """One launch of ``counter``'s kernel: ``counter.launches`` goes up by
    one, or, while this thread captures a CUDA graph, the launch is noted
    for the graph's replays to count."""
    noted = getattr(_capture, "noted", None)
    if noted is None:
        counter.launches += 1
    else:
        noted[counter] += 1


@contextlib.contextmanager
def recording():
    """Within the block, this thread captures a CUDA graph: its launches
    run nothing, so they are noted, not counted.  Yields the notes, ``{
    counter: launches}``, that :func:`replayed` counts at each replay."""
    noted, saved = collections.Counter(), getattr(_capture, "noted", None)
    _capture.noted = noted
    try:
        yield noted
    finally:
        _capture.noted = saved


def replayed(noted) -> None:
    """Count the launches of one replay of a graph whose capture noted
    ``noted`` (:func:`recording`)."""
    for counter, n in noted.items():
        counter.launches += n


def row_bytes(t: torch.Tensor) -> int:
    """Bytes of one row of a ``(lanes, rows, ...)`` tensor."""
    return math.prod(t.shape[2:]) * t.element_size()


def ring_trees(pairs, rows: int):
    """The ``(src, dst)`` leaf pairs of a K1-K4 launch as
    :class:`RingTree` descriptors of at most ``MAX_LEAVES`` leaves each, one
    launch each; leaves with empty rows are left out.  ``dst`` is ``(lanes,
    rows, ...)`` (K1's and K3's blocks, K2's and K4's ring) and gives the
    row width.  ``rows`` is the most rows any lane's ring, block, batch or
    stack holds: the kernels' byte offsets are int32, so ``rows *
    row_bytes`` past 32 bits raises ``ValueError``."""
    leaves = []
    for src, dst in pairs:
        rb = row_bytes(dst)
        if rows * rb >= 2 ** 31:
            raise ValueError(f"{rows} rows of {rb} bytes do not fit the "
                             f"kernels' 32-bit byte offsets")
        if rb:
            leaves.append(RingLeaf(src.data_ptr(), dst.data_ptr(), rb))
    for i in range(0, len(leaves), MAX_LEAVES):
        group = leaves[i:i + MAX_LEAVES]
        tree = RingTree(count=len(group))
        for j, leaf in enumerate(group):
            tree.leaf[j] = leaf
        yield tree


def ring_extents_fit(rows: int, *extents: int) -> bool:
    """Whether a K1-K4 launch takes a ring geometry of int32 items: every
    ``int`` argument within 32 bits (:func:`launch`), and the byte offsets
    of ``rows`` rows of one int32 item too (:func:`ring_trees`).  The
    ``kernel_*_available`` predicates answer with it; there is no tiling
    rule."""
    return (all(0 <= int(e) < 2 ** 31 for e in extents)
            and 4 * int(rows) < 2 ** 31)


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
