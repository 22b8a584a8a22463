"""Hopper kernels of the moving-source render, their plain versions and build.

Two kernels, both in ``csrc/segment_select.cu`` (CUDA C++ for ``sm_90a``):

* :func:`select_segments` (K1) — the ownership select of the fused
  crossfade epilogue, in two forms. The select form is
  ``out[b, :, s] = conv_s[b, own(s), :, u]`` with ``u = s − off_al[own(s)]``,
  the function of the Pallas ``select_segments`` of
  sonicsim_tpu/ops/pallas_kernels.py, which it replaces. The ramp form
  applies the crossfade as it selects,
  ``conv_s + ((u + shift)·scale)·conv_d``, reading the two irfft outputs in
  place: on the TPU that ramp rides inside the final irfft
  (mxu_fft.irfft_grid_lerp), here inside the select.
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

# Launches of each kernel (K1 by form) in this process; plain-version calls
# are not counted.
LAUNCHES = {"select_segments": 0, "select_segments_ramp": 0,
            "crossfade_combine": 0}

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


def select_segments_ref(conv_s: torch.Tensor, off_true: torch.Tensor,
                        off_al: torch.Tensor, t: int,
                        conv_d: torch.Tensor | None = None,
                        shift: torch.Tensor | None = None,
                        scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain K1: windows (B, N, C, span), tables (B, N) → (B, C, T).

    With ``conv_d`` (same shape) and ``shift``/``scale`` (B, N), the windows
    are first combined as ``conv_s + ((u + shift)·scale)·conv_d``, u the
    window position, one rounded op at a time."""
    bsz, _, c, span = conv_s.shape
    combined = conv_s
    if conv_d is not None:
        dtype = conv_s.dtype
        u = torch.arange(span, dtype=dtype, device=conv_s.device)
        ramp = (u + shift[..., None].to(dtype)) * scale[..., None].to(dtype)
        combined = conv_s + ramp[:, :, None, :] * conv_d
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


def build(verbose: bool = False, source: Path = SOURCE) -> Path:
    """Compile ``source`` (``csrc/segment_select.cu`` by default; once per
    source and flags) and return the shared library's path."""
    key = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{source.stem}_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(source)]
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
            p, p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, ctypes.c_int, p,
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
    if not 1 <= n <= MAX_SEGMENTS:
        raise ValueError(f"{name}: N={n} outside [1, {MAX_SEGMENTS}]")
    if bsz > MAX_BATCH:
        raise ValueError(f"{name}: batch {bsz} > {MAX_BATCH}")


def _row_stride(name: str, x: torch.Tensor) -> int:
    """Row stride ``rs`` of a (B, N, C, span) operand laid out as the
    kernel reads it, row (b, i, ch) at ((b·N + i)·C + ch)·rs with rs ≥ span
    and unit stride along span: a contiguous tensor, or the irfft output
    (B, N, C, nfft) sliced along its last axis. Raises on anything else."""
    _, n, c, span = x.shape
    rs = x.stride(2)
    if rs < span or x.stride() != (n * c * rs, c * rs, rs, 1):
        raise ValueError(
            f"{name}: rows must have unit stride and lie at a common row "
            f"stride >= span, got strides {x.stride()} for shape "
            f"{tuple(x.shape)}"
        )
    return rs


def _launch_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")


def select_segments(conv_s: torch.Tensor, off_true: torch.Tensor,
                    off_al: torch.Tensor, t: int,
                    conv_d: torch.Tensor | None = None,
                    shift: torch.Tensor | None = None,
                    scale: torch.Tensor | None = None) -> torch.Tensor:
    """K1. conv_s (B, N, C, span), tables (B, N) → (B, C, T).

    ``conv_d=None`` is the select form. With ``conv_d`` (same shape and
    strides) and ``shift``/``scale`` (B, N), the ramp form:
    ``out[b, c, s] = conv_s[b, own, c, u] + ((u + shift[b, own])·
    scale[b, own])·conv_d[b, own, c, u]``, u = within(s). The operands may
    be the irfft outputs sliced in place (see :func:`_row_stride`); the
    kernel reads them there and nothing is copied."""
    if conv_s.dim() != 4:
        raise ValueError(f"conv_s must be (B, N, C, span), got {tuple(conv_s.shape)}")
    bsz, n, c, span = conv_s.shape
    rs = _row_stride("conv_s", conv_s)
    ramp = conv_d is not None
    if ramp:
        if conv_d.shape != conv_s.shape or conv_d.device != conv_s.device:
            raise ValueError(f"conv_d must match conv_s {tuple(conv_s.shape)} "
                             f"on {conv_s.device}, got {tuple(conv_d.shape)} "
                             f"on {conv_d.device}")
        if conv_d.stride() != conv_s.stride():
            raise ValueError(f"conv_d strides {conv_d.stride()} differ from "
                             f"conv_s {conv_s.stride()}")
        for name, v in (("shift", shift), ("scale", scale)):
            if v is None or tuple(v.shape) != (bsz, n) or v.device != conv_s.device:
                raise ValueError(f"the ramp form needs {name} ({bsz}, {n}) on "
                                 f"{conv_s.device}")
    elif shift is not None or scale is not None:
        raise ValueError("shift and scale go with conv_d (the ramp form)")
    off_true, off_al = _tables(off_true, off_al, bsz, n, conv_s.device)
    if conv_s.device.type == "cpu":
        return select_segments_ref(conv_s, off_true, off_al, t, conv_d, shift, scale)
    if conv_s.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {conv_s.device}")
    _check_cuda("select_segments", conv_s, n, bsz)
    ptrs = [None, None, None]
    if ramp:
        for name, v in (("conv_d", conv_d), ("shift", shift), ("scale", scale)):
            if v.dtype != torch.float32:
                raise TypeError(f"select_segments: {name} must be float32, got {v.dtype}")
        shift, scale = shift.contiguous(), scale.contiguous()
        ptrs = [conv_d.data_ptr(), shift.data_ptr(), scale.data_ptr()]
    out = torch.empty((bsz, c, t), device=conv_s.device, dtype=torch.float32)
    status = _library().sonicsim_select_segments(
        conv_s.data_ptr(), *ptrs, off_true.data_ptr(), off_al.data_ptr(),
        out.data_ptr(), bsz, n, c, span, rs, t, conv_s.device.index,
        torch.cuda.current_stream(conv_s.device).cuda_stream,
    )
    _launch_status("select_segments", status)
    LAUNCHES["select_segments_ramp" if ramp else "select_segments"] += 1
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
    if not conv.is_contiguous():
        raise ValueError("crossfade_combine: conv must be contiguous")
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
