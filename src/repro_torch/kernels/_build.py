"""Build and load the port's CUDA kernels.

Every source under ``kernels/csrc/`` is compiled by ``nvcc`` for ``sm_90a``
(one process per source, all started together; the ``*.cuh`` headers they
include are part of the hash) and linked into one shared library, ``build/repro_torch/libkernels.so`` under the repository root. The
library has a plain C interface and is loaded with ``ctypes``: every pointer
and the stream are ``c_void_p``. It is rebuilt when a hash of the sources
and flags changes. Nothing is built or loaded at import time.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libkernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the entry points (all return an int: cudaError_t, or for
# rt_ccl_scratch_ints a size).
SIGNATURES = {
    "rt_color_deconv": [P, P, P, LL, F, P],
    "rt_morph_recon_rounds": [P, P, P, P, I, I, I, I, P],
    "rt_ccl": [P, P, P, I, I, P, P],
    "rt_ccl_scratch_ints": [I, I],
    "rt_glcm": [P, P, P, I, I, I, I, I, P],
    "rt_glcm_global": [P, P, P, I, I, I, I, P],
    "rt_flash_attention": [P, P, P, P, I, I, I, I, I, I, I, F, I, I, I, P],
    "rt_flash_attention_tc": [P, P, P, P, I, I, I, I, I, I, F, I, I, I, P],
    "rt_ssd_scan": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P, P],
}

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()  # one build per process, whichever thread asks first
# The wrappers' launch counters are module globals that the runtime's worker
# threads update at once; `+=` on a global is a read, an add and a write, not
# atomic under the interpreter lock, so every update takes this lock.
counter_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; cannot build kernels")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the sources into the shared library; returns its path."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "libkernels.sha256"
    digest = source_hash()
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    tmp = BUILD_DIR / f"libkernels.{tag}.so"
    try:
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            for src, obj in zip(sources(), objs)
        ]
        logs = [proc.communicate()[0].decode(errors="replace") for proc in procs]
        errors = [f"{src.name}:\n{log}" for src, proc, log in zip(sources(), procs, logs)
                  if proc.returncode != 0]
        if errors:
            raise RuntimeError("nvcc failed\n" + "\n".join(errors))
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed\n{link.stdout}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def event_handles(events: list, n: int) -> ctypes.Array:
    """Append ``n`` timing events to ``events`` and return their handles as
    the ``void* const*`` that an entry point records them through."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for ev in marks:
        ev.record()  # creates the event; the kernel library records it again
    events.extend(marks)
    return (ctypes.c_void_p * n)(*(ev.cuda_event for ev in marks))


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def require(t: torch.Tensor, name: str, dtype: torch.dtype | tuple[torch.dtype, ...],
            ndim: int) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous CUDA tensor of
    ``dtype`` (or of one of several) with ``ndim`` dimensions, not a
    ``DTensor``, which autograd is not recording. The kernels have no backward: their outputs are written
    through ctypes and carry no ``grad_fn``, so a gradient through one would
    be dropped without a word; this refuses the call instead."""
    if isinstance(t, DTensor):
        raise TypeError(
            f"{name}: a DTensor; the kernel would read one rank's local shard as if it were "
            "the whole tensor. Call it on local shards (spec.local_region, local_map)")
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and autograd is recording a "
            "tensor that requires grad (its gradient would be dropped); train on the "
            "plain versions (attn_impl='torch' in the model config, impl='torch' in "
            "kernels.ops) or call under torch.no_grad()")
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got {t.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
