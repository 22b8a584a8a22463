"""flax's bfloat16 LSTM cell scanned over a sequence: a Hopper kernel
(``csrc/bf16_lstm.cu``, CUDA C++ for ``sm_90a``), its plain version and its
wrapper.

flax's ``OptimizedLSTMCell`` computes in the dtype that its carry, its
kernels and its input promote to. Where all three are bfloat16 (the JAX
SkiM's first ``SegLSTM``, whose zero carry takes the input's dtype,
sonicsim_tpu/models/skim.py:52-66), XLA computes each op of the cell in
float32 and rounds its result to bfloat16 (the compiled HLO of
``nn.RNN(nn.OptimizedLSTMCell)``, in flax/linen/recurrent.py's op order).
With ``rnd`` that rounding and ``z`` a gate's pre-activation, gates i, f,
g, o:

* ``dh = rnd(rnd(h·W_hhᵀ) + b)``, the dot in float32 over bfloat16 values;
* ``z = rnd(dh + xp)``, ``xp = rnd(x·W_ihᵀ)`` the rounded input projection;
* ``σ(z) = rnd(1 / rnd(rnd(exp(−z)) + 1))`` for i, f and o, and
  ``g = rnd(tanh(z_g))``;
* ``c′ = rnd(rnd(f·c) + rnd(i·g))`` and ``h′ = rnd(o·rnd(tanh(c′)))``.

The kernel replaces no TPU kernel (the JAX package leaves the scan to XLA),
and no library call computes this function: cuDNN's bfloat16 RNN keeps the
cell in float32. Dispatch is by the tensors' device alone: a CPU tensor
goes to :func:`bf16_lstm_scan_ref`, a CUDA tensor to the kernel, or the
call raises. The library is built with ``nvcc`` at first use into
``_build/`` (``kernels.build``).
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from . import kernels

SOURCE = kernels._PKG / "csrc" / "bf16_lstm.cu"
# Hidden widths the kernel has an instance of: its warps own 16 units each,
# and a warp's slice of W_hh (8 · H / 16 · 2 registers) stays in registers.
HIDDEN = tuple(range(16, 129, 16))

# Launches of the kernel in this process; plain-version calls are not
# counted.
LAUNCHES = {"bf16_lstm_scan": 0}

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _rnd(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _sigmoid(z: torch.Tensor) -> torch.Tensor:
    """flax's sigmoid as XLA expands it in bfloat16, each op rounded."""
    return _rnd(1.0 / _rnd(_rnd(torch.exp(-z)) + 1.0))


def bf16_lstm_scan_ref(xp: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
                       h0: torch.Tensor, c0: torch.Tensor,
                       reverse: Sequence[bool]) -> tuple:
    """Plain version of :func:`bf16_lstm_scan`: the rounding schedule of the
    module docstring, one step at a time, every direction at once."""
    n, k, _ = xp.shape
    dirs, gates, hidden = w_hh.shape
    w_t = w_hh.float().transpose(1, 2)  # (D, H, 4H)
    b = bias.float()[:, None, :]
    x = xp.float().reshape(n, k, dirs, gates)
    h, c = h0.float(), c0.float()
    out = torch.empty(n, k, dirs, hidden, dtype=torch.bfloat16, device=xp.device)
    lanes = torch.arange(dirs, device=xp.device)
    for step in range(k):
        at = torch.tensor([k - 1 - step if r else step for r in reverse], device=xp.device)
        z = _rnd(_rnd(_rnd(torch.bmm(h, w_t)) + b) + x[:, at, lanes].transpose(0, 1))
        zi, zf, zg, zo = z.split(hidden, dim=-1)
        c = _rnd(_rnd(_sigmoid(zf) * c) + _rnd(_sigmoid(zi) * _rnd(torch.tanh(zg))))
        h = _rnd(_sigmoid(zo) * _rnd(torch.tanh(c)))
        out[:, at, lanes] = h.transpose(0, 1).to(torch.bfloat16)
    return (out.reshape(n, k, dirs * hidden), h.to(torch.bfloat16), c.to(torch.bfloat16))


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(kernels.build(source=SOURCE)))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.sonicsim_bf16_lstm_scan.argtypes = [p] * 8 + [i64] * 5 + [ctypes.c_int, p]
        lib.sonicsim_bf16_lstm_scan.restype = ctypes.c_int
        _lib = lib
    return _lib


def bf16_lstm_scan(xp: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
                   h0: torch.Tensor, c0: torch.Tensor, reverse: Sequence[bool]) -> tuple:
    """flax's bfloat16 LSTM cell over D directions of N sequences of K
    steps, every tensor bfloat16:

    * ``xp`` (N, K, D·4H): each direction's rounded input projection,
      side by side on the last axis (``zoo_layers._rounded_projection``);
    * ``w_hh`` (D, 4H, H), torch's gate order (i, f, g, o), and ``bias``
      (D, 4H), flax's one bias per gate;
    * ``h0``, ``c0`` (D, N, H), torch's state layout; ``reverse`` one flag
      per direction: that direction walks from step K − 1 down to 0.

    Returns the outputs (N, K, D·H), ``[direction 0, direction 1]`` on the
    last axis, each at the step that made it, and the final ``(h, c)``,
    each (D, N, H)."""
    if xp.dim() != 3 or w_hh.dim() != 3:
        raise ValueError(f"xp must be (N, K, D·4H) and w_hh (D, 4H, H), got "
                         f"{tuple(xp.shape)} and {tuple(w_hh.shape)}")
    n, k, width = xp.shape
    dirs, gates, hidden = w_hh.shape
    if gates != 4 * hidden or width != dirs * gates or len(reverse) != dirs:
        raise ValueError(f"xp {tuple(xp.shape)}, w_hh {tuple(w_hh.shape)} and "
                         f"{len(reverse)} reverse flags do not agree")
    for name, t, shape in (("bias", bias, (dirs, gates)), ("h0", h0, (dirs, n, hidden)),
                           ("c0", c0, (dirs, n, hidden))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("xp", xp), ("w_hh", w_hh), ("bias", bias), ("h0", h0), ("c0", c0)):
        if t.dtype != torch.bfloat16 or t.device != xp.device:
            raise TypeError(f"{name} must be bfloat16 on {xp.device}, got {t.dtype} on "
                            f"{t.device}")
    if xp.device.type == "cpu":
        return bf16_lstm_scan_ref(xp, w_hh, bias, h0, c0, reverse)
    if xp.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xp.device}")
    if hidden not in HIDDEN:
        raise ValueError(f"bf16_lstm_scan: the kernel takes a hidden width in {HIDDEN}, "
                         f"got {hidden}")
    if n * k * width >= 2**62 or k >= 2**31 or n >= 2**31:
        raise ValueError(f"bf16_lstm_scan: N={n}, K={k} too large")
    xp, w_hh, bias, h0, c0 = (t.contiguous() for t in (xp, w_hh, bias, h0, c0))
    y = torch.empty(n, k, dirs * hidden, dtype=torch.bfloat16, device=xp.device)
    if k == 0:
        return y, h0.clone(), c0.clone()
    hn, cn = torch.empty_like(h0), torch.empty_like(c0)
    mask = sum(1 << d for d, r in enumerate(reverse) if r)
    status = _library().sonicsim_bf16_lstm_scan(
        xp.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        y.data_ptr(), hn.data_ptr(), cn.data_ptr(), n, k, dirs, hidden, mask,
        xp.device.index, torch.cuda.current_stream(xp.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"bf16_lstm_scan kernel launch failed: cudaError {status}")
    LAUNCHES["bf16_lstm_scan"] += 1
    return y, hn, cn
