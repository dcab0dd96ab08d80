"""Build and load the port's hand-written CUDA kernels.

All ``csrc/*.cu`` files compile with ``nvcc`` into ONE shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), which is
loaded with ``ctypes``.  The build runs at first use, into
``gshell_tpu_torch/_build/<hash of the sources and flags>/``, so a fresh
checkout builds itself and an edited source rebuilds.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that products
and sums round exactly as PyTorch's eager elementwise ops do — the stage-B
kernel's top-left tie test (``e == 0``) and the z tie-break are compared
bit-for-bit against the plain version.  ``--use_fast_math`` is never passed:
it changes ``expf``, division and reciprocal rounding.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lib = None
build_seconds: float | None = None


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
    )


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + [os.path.join(CSRC_DIR, f) for f in sorted(os.listdir(CSRC_DIR)) if f.endswith(".cuh")]:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile the kernels if needed; return the path of the shared library."""
    global build_seconds
    srcs = _sources()
    out_dir = os.path.join(BUILD_ROOT, _digest(srcs))
    so = os.path.join(out_dir, "libgshell_kernels.so")
    if os.path.exists(so):
        if build_seconds is None:  # built by an earlier process
            build_seconds = 0.0
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *srcs]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, so)  # atomic: a concurrent build never sees a partial file
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        handle.gs_stage_b.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, vp]
        handle.gs_stage_b.restype = i32
        handle.gs_stage_b_layout.argtypes = [vp, vp]
        handle.gs_stage_b_layout.restype = None
        handle.gs_bilateral.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, f32, i32, vp]
        handle.gs_bilateral.restype = i32
        i64 = ctypes.c_longlong
        handle.gs_scatter_rows.argtypes = [vp, i32, vp, i64, vp, i64, i32, vp, vp]
        handle.gs_scatter_rows.restype = i32
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype, shape=None, device=None) -> None:
    """Wrapper-side argument checks: device, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
