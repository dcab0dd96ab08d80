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

Every launch goes through :func:`check`, which also counts it:
:func:`kernel_launches` reads the counts (they stay 0 on the CPU, where the
plain versions run).
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

# The name each launch site of the port gives :func:`check` → the key it
# counts under; a launch named otherwise (a test's probe) is not counted.
COUNTED_AS = {"rasterize_stage_b": "rasterize_stage_b", "bilateral_accumulate": "bilateral_accumulate",
              "scatter_rows": "gather_rows", "mc_shade_fwd": "mc_shade", "mc_shade_bwd": "mc_shade"}
_launches = dict.fromkeys(COUNTED_AS.values(), 0)


class McShadeArgs(ctypes.Structure):
    """``mc::Args`` of ``csrc/mc_shade.cuh``, field for field."""

    _vp, _i32, _i64, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    _fields_ = [
        ("rows", _vp), ("P", _i64), ("u", _vp), ("c", _vp), ("pool", _vp), ("n_pool", _i64),
        ("light", _vp), ("light_bf16", _i32), ("diffuse_only", _i32), ("n", _i32), ("lh", _i32), ("lw", _i32),
        ("inv_n2", _f32), ("strata", _f32), ("ss", _f32), ("omss", _f32), ("hw", _f32),
        ("field", _vp), ("grid", _vp), ("ko", _i32), ("r", _i32), ("words", _i32), ("n_steps", _i32),
        ("trilinear", _i32), ("t0", _f32), ("dt", _f32), ("thr", _f32), ("hi", _f32),
        ("amin", _f32 * 3), ("ascale", _f32 * 3),
        ("out", _vp), ("stats", _vp),
        ("g", _vp), ("g_rows", _vp), ("g_pool", _vp), ("scratch", _vp), ("g_light", _vp),
        ("j0", _i32), ("k", _i32),
    ]


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
        handle.gs_mc_shade_fwd.argtypes = [ctypes.POINTER(McShadeArgs), vp]
        handle.gs_mc_shade_fwd.restype = i32
        handle.gs_mc_shade_bwd.argtypes = [ctypes.POINTER(McShadeArgs), vp]
        handle.gs_mc_shade_bwd.restype = i32
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch; otherwise
    count the launch under ``COUNTED_AS[name]``, if it names one."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    if name in COUNTED_AS:
        _launches[COUNTED_AS[name]] += 1


def kernel_launches() -> dict:
    """The hand kernels' launches since the process started (or since
    :func:`zero_launches`), by key: ``rasterize_stage_b`` (three CUDA kernels
    each: schedule, test, unpack), ``bilateral_accumulate``, ``gather_rows``
    (the gathers' backward) and ``mc_shade`` (a forward walk 1, a reverse
    walk one a block of samples)."""
    return dict(_launches)


def launches_since(start: dict) -> dict:
    now = kernel_launches()
    return {k: now[k] - start[k] for k in now}


def zero_launches() -> None:
    """Every launch count to 0."""
    for k in _launches:
        _launches[k] = 0


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
