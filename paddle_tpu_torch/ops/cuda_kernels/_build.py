"""Build and bind the hand-written Hopper kernels (CUDA C++ for sm_90a).

Each `csrc/<name>.cu` compiles with `nvcc` into its own shared library with
a plain C interface, loaded with ctypes; `csrc/*.cuh` are headers they
share. Nothing is built at import: the
first wrapper call on a CUDA tensor builds every source at once (one `nvcc`
per source, all started together) into `build/` beside this file, which
`.gitignore` lists. A library's file name carries a hash of its source and
flags, so an edited source rebuilds and an unchanged one is reused.

Several threads may launch kernels at once (the serving fleet's threaded
pump runs one executor a replica on worker threads): `library` builds and
loads under one lock, each build writes a temporary named by its process
and thread before the atomic rename, and `count` increments under a lock.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("paged_attention", "prefill_attention", "layer_norm",
           "attention_backward", "layer_norm_backward", "softmax_xent_fwd",
           "softmax_xent_bwd", "bn_apply", "bn_apply_backward",
           "bottleneck_block", "flash_attention", "flash_attention_backward",
           "attn_probe", "dma_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels are built from source at first use")
    return path


def library_path(name: str) -> Path:
    """The library of `name`; its hash covers the source, the shared
    headers (csrc/*.cuh) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel.
    Returns the wall seconds spent; raises with the compiler output of
    every source that failed. Each source's compiler output (including
    `-Xptxas -v` register and spill counts) is kept in build/<name>.log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for name in SOURCES:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(
            f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_bytes(out)
        if proc.returncode:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          + out.decode(errors="replace"))
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source `name`, building all first. The
    first callers of several threads wait on one build and one load."""
    lib = _libs.get(name)
    if lib is None:
        with _lib_lock:
            lib = _libs.get(name)
            if lib is None:
                build_all()
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def bind(lib: ctypes.CDLL, fn: str, argtypes) -> ctypes._CFuncPtr:
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
          device: torch.device) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and rank
    `ndim` on `device` — all a kernel takes."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# the element types the kernels take, and the suffix of their C entries
ELEM = {torch.float32: "f32", torch.bfloat16: "bf16"}


def elem(what: str, t: torch.Tensor) -> str:
    """The C entry suffix for `t`'s dtype; raises on a dtype no kernel
    instantiation takes."""
    if t.dtype not in ELEM:
        raise TypeError(f"{what} takes float32 or bfloat16 tensors, got "
                        f"{t.dtype}")
    return ELEM[t.dtype]


def count(wrapper, dtype: torch.dtype) -> None:
    """One launch of `wrapper`'s kernel on `dtype` tensors: its total count
    and its count by dtype."""
    key = str(dtype).replace("torch.", "")
    with _count_lock:
        wrapper.launches += 1
        wrapper.launches_by_dtype[key] = \
            wrapper.launches_by_dtype.get(key, 0) + 1


def launch(kernel: str, fn, *args) -> None:
    """Call a C entry point; it returns cudaGetLastError() after its launch."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {rc}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
