"""Hopper kernels of the moving-source render, their plain versions and build.

Two kernels, both in ``csrc/segment_select.cu`` (CUDA C++ for ``sm_90a``):

* :func:`select_segments` (K1) — the ownership select after the fused
  crossfade epilogue: ``out[b, :, s] = combined[b, own(s), :, s − off_al[own(s)]]``.
  Replaces the Pallas ``select_segments`` of sonicsim_tpu/ops/pallas_kernels.py.
* :func:`crossfade_combine` (K2) — the same select over (start, end) conv
  pairs with a per-sample lerp, ``(1 − w)·start + w·end``. Replaces the
  Pallas ``crossfade_combine``.

``own(s) = clip(searchsorted(off_true, s, 'right') − 1, 0, N − 1)`` and the
window position is clipped to ``[0, span − 1]``, exactly as in the reference's
gather forms (fftconv._fused_lerp_select / _ownership_combine), for any
segment length.

Dispatch is by the tensor's device alone: a CPU tensor goes to the plain
PyTorch version (``*_ref``), a CUDA tensor to the kernel, or the call
raises. The library is built with ``nvcc`` at first use into ``_build/``
beside the package, from the sources in ``csrc/`` only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "segment_select.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# Two int32 tables of N entries each in static-size shared memory (48 KB).
MAX_SEGMENTS = 6144
MAX_BATCH = 65535  # grid.y

# Launches of each kernel in this process (plain-version calls not counted).
LAUNCHES = {"select_segments": 0, "crossfade_combine": 0}

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------- plain ----


def _ownership(off_true: torch.Tensor, off_al: torch.Tensor, span: int,
               t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(own, within), each (B, T) int64, for (B, N) segment tables."""
    bsz, n = off_true.shape
    tt = torch.arange(t, device=off_true.device, dtype=torch.int64)
    own = torch.searchsorted(
        off_true.to(torch.int64).contiguous(),
        tt.expand(bsz, t).contiguous(), right=True,
    ) - 1
    own = own.clamp(0, n - 1)
    within = (tt - off_al.to(torch.int64).gather(1, own)).clamp(0, span - 1)
    return own, within


def select_segments_ref(combined: torch.Tensor, off_true: torch.Tensor,
                        off_al: torch.Tensor, t: int) -> torch.Tensor:
    """Plain K1: combined (B, N, C, span), tables (B, N) → (B, C, T)."""
    bsz, _, c, span = combined.shape
    own, within = _ownership(off_true, off_al, span, t)
    ch = torch.arange(c, device=combined.device)[None, :, None] * span
    idx = (own * (c * span) + within)[:, None, :] + ch  # (B, C, T)
    return combined.reshape(bsz, -1).gather(1, idx.reshape(bsz, -1)).reshape(
        bsz, c, t
    )


def crossfade_combine_ref(conv: torch.Tensor, w: torch.Tensor,
                          off_true: torch.Tensor, off_al: torch.Tensor,
                          t: int) -> torch.Tensor:
    """Plain K2: conv (B, N, 2, C, span), w (B, T), tables (B, N) → (B, C, T)."""
    bsz, _, _, c, span = conv.shape
    own, within = _ownership(off_true, off_al, span, t)
    ch = torch.arange(c, device=conv.device)[None, :, None] * span
    idx = (own * (2 * c * span) + within)[:, None, :] + ch  # start windows
    flat = conv.reshape(bsz, -1)
    start = flat.gather(1, idx.reshape(bsz, -1)).reshape(bsz, c, t)
    end = flat.gather(1, (idx + c * span).reshape(bsz, -1)).reshape(bsz, c, t)
    wt = w[:, None, :]
    return (1.0 - wt) * start + wt * end


# ----------------------------------------------------------------- build ----


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/segment_select.cu`` (once per source and flags) and
    return the shared library's path."""
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"libsegment_select_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    if verbose:
        print(r.stderr, end="")
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.sonicsim_select_segments.argtypes = [
            p, p, p, p, i64, i64, i64, i64, i64, ctypes.c_int, p,
        ]
        lib.sonicsim_crossfade_combine.argtypes = [
            p, p, p, p, p, i64, i64, i64, i64, i64, ctypes.c_int, p,
        ]
        lib.sonicsim_select_segments.restype = ctypes.c_int
        lib.sonicsim_crossfade_combine.restype = ctypes.c_int
        _lib = lib
    return _lib


# --------------------------------------------------------------- wrappers ----


def _tables(off_true, off_al, bsz: int, n: int, device):
    """Segment tables, (B, N) int32 or int64 on ``device``, as int32
    contiguous."""
    out = []
    for name, o in (("off_true", off_true), ("off_al", off_al)):
        if o.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got {o.dtype}")
        if tuple(o.shape) != (bsz, n) or o.device != device:
            raise ValueError(f"{name} must be ({bsz}, {n}) on {device}, "
                             f"got {tuple(o.shape)} on {o.device}")
        out.append(o.to(torch.int32).contiguous())
    return out


def _check_cuda(name: str, x: torch.Tensor, n: int, bsz: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if not 1 <= n <= MAX_SEGMENTS:
        raise ValueError(f"{name}: N={n} outside [1, {MAX_SEGMENTS}]")
    if bsz > MAX_BATCH:
        raise ValueError(f"{name}: batch {bsz} > {MAX_BATCH}")


def _launch_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")


def select_segments(combined: torch.Tensor, off_true: torch.Tensor,
                    off_al: torch.Tensor, t: int) -> torch.Tensor:
    """K1. combined (B, N, C, span), tables (B, N) → (B, C, T)."""
    if combined.dim() != 4:
        raise ValueError(f"combined must be (B, N, C, span), got {tuple(combined.shape)}")
    bsz, n, c, span = combined.shape
    off_true, off_al = _tables(off_true, off_al, bsz, n, combined.device)
    if combined.device.type == "cpu":
        return select_segments_ref(combined, off_true, off_al, t)
    if combined.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {combined.device}")
    _check_cuda("select_segments", combined, n, bsz)
    out = torch.empty((bsz, c, t), device=combined.device, dtype=torch.float32)
    status = _library().sonicsim_select_segments(
        combined.data_ptr(), off_true.data_ptr(), off_al.data_ptr(),
        out.data_ptr(), bsz, n, c, span, t, combined.device.index,
        torch.cuda.current_stream(combined.device).cuda_stream,
    )
    _launch_status("select_segments", status)
    LAUNCHES["select_segments"] += 1
    return out


def crossfade_combine(conv: torch.Tensor, w: torch.Tensor,
                      off_true: torch.Tensor, off_al: torch.Tensor,
                      t: int) -> torch.Tensor:
    """K2. conv (B, N, 2, C, span), w (B, T), tables (B, N) → (B, C, T)."""
    if conv.dim() != 5 or conv.shape[2] != 2:
        raise ValueError(f"conv must be (B, N, 2, C, span), got {tuple(conv.shape)}")
    bsz, n, _, c, span = conv.shape
    off_true, off_al = _tables(off_true, off_al, bsz, n, conv.device)
    if tuple(w.shape) != (bsz, t) or w.device != conv.device:
        raise ValueError(f"w must be ({bsz}, {t}) on {conv.device}")
    if conv.device.type == "cpu":
        return crossfade_combine_ref(conv, w.to(conv.dtype), off_true, off_al, t)
    if conv.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {conv.device}")
    _check_cuda("crossfade_combine", conv, n, bsz)
    if w.dtype != torch.float32:
        raise TypeError(f"crossfade_combine: w must be float32, got {w.dtype}")
    w = w.contiguous()
    out = torch.empty((bsz, c, t), device=conv.device, dtype=torch.float32)
    status = _library().sonicsim_crossfade_combine(
        conv.data_ptr(), w.data_ptr(), off_true.data_ptr(), off_al.data_ptr(),
        out.data_ptr(), bsz, n, c, span, t, conv.device.index,
        torch.cuda.current_stream(conv.device).cuda_stream,
    )
    _launch_status("crossfade_combine", status)
    LAUNCHES["crossfade_combine"] += 1
    return out
