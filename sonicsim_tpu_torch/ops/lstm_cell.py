"""flax's bfloat16 LSTM cell scanned over a sequence, forward and backward:
Hopper kernels (``csrc/bf16_lstm.cu``, CUDA C++ for ``sm_90a``), their plain
versions and their wrappers, and :func:`bf16_lstm`, the layer under
autograd.

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

The gradients are those of the compiled HLO of ``jax.vjp`` of that scan
(:func:`bf16_lstm_scan_backward_ref`, :func:`bf16_running_sum_ref`): each
op of the cell's VJP rounded, and each weight's and bias's gradient a
bfloat16 running sum over the steps in the transpose loop's order.

The kernels replace no TPU kernel (the JAX package leaves the scan and its
VJP to XLA), and no library call computes these functions: cuDNN's
bfloat16 RNN keeps the cell in float32. Dispatch is by the tensors' device
alone: a CPU tensor goes to the plain version, a CUDA tensor to the kernel,
or the call raises. The library is built with ``nvcc`` at first use into
``_build/`` (``kernels.build``).
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from . import kernels

SOURCE = kernels._PKG / "csrc" / "bf16_lstm.cu"
# Hidden widths the kernels have an instance of: their warps own 8 units
# each, and a warp's slice of W_hh (H / 2 registers) stays in registers.
HIDDEN = tuple(range(16, 129, 16))

# Launches of each kernel in this process (the running sum's two instances
# apart: a bfloat16 dz, the bf16 cell's, and a float32 one, a float32
# carry's); plain-version calls are not counted.
LAUNCHES = {"bf16_lstm_scan": 0, "bf16_lstm_scan_train": 0, "bf16_lstm_scan_backward": 0,
            "bf16_running_sum": 0, "bf16_running_sum_f32dz": 0}

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
                       reverse: Sequence[bool], keep: bool = False) -> tuple:
    """Plain version of :func:`bf16_lstm_scan`: the rounding schedule of the
    module docstring, one step at a time, every direction at once."""
    n, k, _ = xp.shape
    dirs, gates, hidden = w_hh.shape
    w_t = w_hh.float().transpose(1, 2)  # (D, H, 4H)
    b = bias.float()[:, None, :]
    x = xp.float().reshape(n, k, dirs, gates)
    h, c = h0.float(), c0.float()
    out = torch.empty(n, k, dirs, hidden, dtype=torch.bfloat16, device=xp.device)
    if keep:
        zs = torch.empty(n, k, dirs, gates, dtype=torch.bfloat16, device=xp.device)
        cs = torch.empty_like(out)
    lanes = torch.arange(dirs, device=xp.device)
    for step in range(k):
        at = _at(step, k, reverse, xp.device)
        z = _rnd(_rnd(_rnd(torch.bmm(h, w_t)) + b) + x[:, at, lanes].transpose(0, 1))
        zi, zf, zg, zo = z.split(hidden, dim=-1)
        i, f, g, o = _sigmoid(zi), _sigmoid(zf), _rnd(torch.tanh(zg)), _sigmoid(zo)
        c = _rnd(_rnd(f * c) + _rnd(i * g))
        h = _rnd(o * _rnd(torch.tanh(c)))
        out[:, at, lanes] = h.transpose(0, 1).to(torch.bfloat16)
        if keep:
            zs[:, at, lanes] = torch.cat([i, f, g, o], -1).transpose(0, 1).to(torch.bfloat16)
            cs[:, at, lanes] = c.transpose(0, 1).to(torch.bfloat16)
    result = (out.reshape(n, k, dirs * hidden), h.to(torch.bfloat16), c.to(torch.bfloat16))
    if keep:
        result += (zs.reshape(n, k, dirs * gates), cs.reshape(n, k, dirs * hidden))
    return result


def _at(step: int, k: int, reverse: Sequence[bool], device) -> torch.Tensor:
    """Each direction's time at its ``step``-th step."""
    return torch.tensor([k - 1 - step if r else step for r in reverse], device=device)


def bf16_lstm_scan_backward_ref(dy: torch.Tensor, dhn: torch.Tensor, dcn: torch.Tensor,
                                gates: torch.Tensor, c: torch.Tensor, w_hh: torch.Tensor,
                                c0: torch.Tensor, reverse: Sequence[bool]) -> tuple:
    """Plain version of :func:`bf16_lstm_scan_backward`: the VJP of the scan
    as the compiled HLO of ``jax.vjp`` computes it, each op rounded, walking
    each direction's steps backwards. ``gates`` and ``c`` are the forward's
    rounded gates i, f, g, o (N, K, D·4H) and cells (N, K, D·H)
    (``keep=True``); ``dy`` (N, K, D·H) and ``dhn``, ``dcn`` (D, N, H) the
    cotangents of the outputs and of the final ``(h, c)``. With ct_h, ct_c
    a step's cotangents of its ``(h′, c′)`` and τ = tanh(c′) rounded:

    * ``u = rnd(rnd(o·ct_h)·rnd(1 − τ))``,
      ``dc = rnd(rnd(ct_c + u) + rnd(u·τ))``;
    * ``dz_i = rnd(rnd(dc·g)·rnd(i·rnd(1 − i)))``, ``dz_f`` the same of
      ``rnd(dc·c)`` and f, ``dz_o = rnd(rnd(ct_h·τ)·rnd(o·rnd(1 − o)))``,
      and with ``v = rnd(rnd(i·dc)·rnd(1 − g))``, ``dz_g = rnd(v + rnd(v·g))``;
    * the previous step's ``ct_c = rnd(f·dc)`` and ``ct_h = rnd(rnd(dz·W_hh)
      + dy)``, the dot in float32 over bfloat16 values.

    Returns ``dz`` (N, K, D·4H), which is also the cotangent of ``xp``, and
    the cotangents of ``h0`` and ``c0`` (D, N, H), all bfloat16."""
    n, k, width = gates.shape
    dirs, _, hidden = w_hh.shape
    w = w_hh.float()
    gg = gates.float().reshape(n, k, dirs, width // dirs)
    cc = c.float().reshape(n, k, dirs, hidden)
    dyy = dy.float().reshape(n, k, dirs, hidden)
    dh, dc_next = dhn.float(), dcn.float()
    dz_all = torch.empty(n, k, dirs, width // dirs, dtype=torch.bfloat16, device=gates.device)
    lanes = torch.arange(dirs, device=gates.device)
    for step in reversed(range(k)):
        at = _at(step, k, reverse, gates.device)
        i, f, g, o = gg[:, at, lanes].transpose(0, 1).split(hidden, dim=-1)
        c_prev = c0.float() if step == 0 else cc[:, _at(step - 1, k, reverse, gates.device),
                                                 lanes].transpose(0, 1)
        tc = _rnd(torch.tanh(cc[:, at, lanes].transpose(0, 1)))
        ct_h = _rnd(dh + dyy[:, at, lanes].transpose(0, 1))
        u = _rnd(_rnd(o * ct_h) * _rnd(1.0 - tc))
        dc = _rnd(_rnd(dc_next + u) + _rnd(u * tc))
        v = _rnd(_rnd(i * dc) * _rnd(1.0 - g))
        dz = torch.cat([_rnd(_rnd(dc * g) * _rnd(i * _rnd(1.0 - i))),
                        _rnd(_rnd(dc * c_prev) * _rnd(f * _rnd(1.0 - f))),
                        _rnd(v + _rnd(v * g)),
                        _rnd(_rnd(ct_h * tc) * _rnd(o * _rnd(1.0 - o)))], dim=-1)
        dz_all[:, at, lanes] = dz.transpose(0, 1).to(torch.bfloat16)
        dc_next = _rnd(f * dc)
        dh = _rnd(torch.bmm(dz, w))
    return (dz_all.reshape(n, k, width), dh.to(torch.bfloat16), dc_next.to(torch.bfloat16))


def step_products(dz: torch.Tensor, x: torch.Tensor, y: torch.Tensor, h0: torch.Tensor,
                  reverse: Sequence[bool], dz_x: torch.Tensor | None = None,
                  walk: tuple[int, int] | None = None) -> torch.Tensor:
    """Each step's weight gradient before rounding: ``dz_tᵀ · [h_{t−1} |
    x_t]`` over the N rows, in float32 on the given values, (D, K, 4H,
    H + C), ``h_{t−1}`` the state each direction's step ``t`` read. Plain
    batched products, as XLA computes them outside any kernel of the JAX
    package: one ``bmm`` a direction on strided views (two where ``dz_x``,
    the cotangent the input dense reads, differs from ``dz``).

    With ``walk = (o0, o1)`` only the walk positions ``[o0, o1)`` of the
    transpose loop (position o is step K − 1 − o of a forward direction and
    step o of a reversed one), each direction's steps in time order:
    the products :func:`walk_chunk` pairs with its ``dz``."""
    n, k, width = dz.shape
    dirs, _, hidden = h0.shape
    gates = width // dirs
    o0, o1 = walk if walk is not None else (0, k)
    on_card = dz.device.type == "cuda"
    if on_card and torch.float32 in (dz.dtype, x.dtype) \
            and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("step_products: a float32 product would run in TF32; turn TF32 "
                           "off (scripts.common.strict_float32)")
    # On the card bfloat16 operands stay bfloat16 and the GEMM accumulates and
    # returns float32: the same exact products, summed in float32.
    cast = (lambda t: t) if on_card else (lambda t: t.float())
    dzs = cast(dz).reshape(n, k, dirs, gates)
    dxs = dzs if dz_x is None else cast(dz_x).reshape(n, k, dirs, gates)
    xs, ys = cast(x), cast(y).reshape(n, k, dirs, hidden)
    out = torch.empty(dirs, o1 - o0, gates, hidden + x.shape[-1], dtype=torch.float32,
                      device=dz.device)
    for d, r in enumerate(reverse):
        a, b = (o0, o1) if r else (k - o1, k - o0)
        hd, first = ys[:, :, d], cast(h0[d])[:, None]
        h_prev = torch.cat([hd[:, 1:], first], 1) if r else torch.cat([first, hd[:, :-1]], 1)
        pairs = [(dzs, torch.cat([h_prev, xs], -1))] if dz_x is None else \
            [(dzs, h_prev), (dxs, xs)]
        col = 0
        for lhs, rhs in pairs:
            lhs = lhs[:, a:b, d].permute(1, 2, 0)  # (S, 4H, N)
            rhs = rhs[:, a:b].transpose(0, 1)  # (S, N, ·)
            wide = on_card and lhs.dtype != torch.float32
            out[d, :, :, col:col + rhs.shape[-1]] = (
                torch.bmm(lhs, rhs, out_dtype=torch.float32) if wide else torch.bmm(lhs, rhs))
            col += rhs.shape[-1]
    return out


def walk_chunk(dz: torch.Tensor, reverse: Sequence[bool], walk: tuple[int, int]
               ) -> torch.Tensor:
    """``dz`` (N, K, D·4H) at the walk positions ``[o0, o1)``
    (:func:`step_products`), each direction's steps in time order: what the
    running sum reads beside those products."""
    k, dirs = dz.shape[1], len(reverse)
    o0, o1 = walk
    if (o0, o1) == (0, k):
        return dz
    gates = dz.shape[2] // dirs
    return torch.cat([dz[:, slice(o0, o1) if r else slice(k - o1, k - o0),
                         d * gates:(d + 1) * gates] for d, r in enumerate(reverse)],
                     dim=-1).contiguous()


ROW_WINDOW = 32  # XLA's TreeReductionRewriter: the rows a reduce-window sums


def row_sum_ref(v: torch.Tensor, rounded: bool = True, lead: int = 1) -> torch.Tensor:
    """``v`` summed over its first ``lead`` axes as XLA's CPU backend sums a
    ``reduce_sum`` of that dtype over them (its TreeReductionRewriter):
    where no summed axis is longer than 32, every element in row-major
    order from 0; else each longer axis padded with zeros to a multiple of
    32 (half the padding, rounded down, in front), each window (32 along
    those axes, the whole of the shorter ones) summed in that order, and
    the window sums summed the same way. A bfloat16 reduce (``rounded``)
    rounds each add, a float32 one none. A bfloat16 ``v`` is summed in
    bfloat16 adds, which round as ``rounded`` does; the result is float32."""
    sizes = v.shape[:lead]
    if all(n <= ROW_WINDOW for n in sizes):
        return _in_order(v.reshape(-1, *v.shape[lead:]), rounded)
    pad, split = [], []
    for n in sizes:
        m = -(-n // ROW_WINDOW) * ROW_WINDOW if n > ROW_WINDOW else n
        pad.append(((m - n) // 2, m - n - (m - n) // 2))
        split += [m // min(m, ROW_WINDOW), min(m, ROW_WINDOW)]
    flat = [0, 0] * (v.dim() - lead) + [p for lo_hi in reversed(pad) for p in lo_hi]
    v = torch.nn.functional.pad(v, flat).reshape(*split, *v.shape[lead:])
    order = [*range(1, 2 * lead, 2), *range(0, 2 * lead, 2), *range(2 * lead, v.dim())]
    windows = v.permute(order).reshape(-1, *v.shape[0:2 * lead:2], *v.shape[2 * lead:])
    sums = _in_order(windows, rounded)
    return row_sum_ref(sums.to(v.dtype) if rounded else sums, rounded, lead)


def _in_order(v: torch.Tensor, rounded: bool = True) -> torch.Tensor:
    if rounded and v.dtype == torch.bfloat16:
        acc = torch.zeros(v.shape[1:], dtype=torch.bfloat16, device=v.device)
        for r in range(v.shape[0]):
            acc.add_(v[r])
        return acc.float()
    acc = torch.zeros(v.shape[1:], dtype=torch.float32, device=v.device)
    for r in range(v.shape[0]):
        acc = _rnd(acc + v[r]) if rounded else acc + v[r]
    return acc


def bf16_running_sum_ref(products: torch.Tensor, dz: torch.Tensor,
                         reverse: Sequence[bool], dw0: torch.Tensor | None = None,
                         db0: torch.Tensor | None = None) -> tuple:
    """Plain version of :func:`bf16_running_sum`: the weight and bias
    gradients as the JAX scan's transpose loop accumulates them, in
    bfloat16, walking each direction's steps from its last to its first,
    from ``dw0`` and ``db0`` (bfloat16; zeros where None):

    * ``dW = rnd(dW + rnd(P_t))`` over ``products`` P (D, K, 4H, H + C);
    * ``db = rnd(db + rnd(s_t))``, ``s_t`` the step's ``dz`` (N, K, D·4H)
      summed over the rows by :func:`row_sum_ref`: a bfloat16 ``dz`` (the
      bfloat16 cell's) with each add rounded, a float32 one (a float32
      carry's) in float32.

    Returns ``dW`` (D, 4H, H + C) and ``db`` (D, 4H), bfloat16."""
    dirs, k = products.shape[:2]
    rows = row_sum_ref(dz.float(), dz.dtype != torch.float32)
    rows = rows.reshape(k, dirs, -1).transpose(0, 1)  # (D, K, 4H)
    dw = torch.zeros((dirs,) + products.shape[2:], dtype=torch.float32, device=dz.device) \
        if dw0 is None else dw0.float()
    db = torch.zeros(rows.shape[0], rows.shape[2], dtype=torch.float32, device=dz.device) \
        if db0 is None else db0.float()
    lanes = torch.arange(dirs, device=dz.device)
    for step in reversed(range(k)):
        at = _at(step, k, reverse, dz.device)
        dw = _rnd(dw + _rnd(products[lanes, at]))
        db = _rnd(db + _rnd(rows[lanes, at]))
    return dw.to(torch.bfloat16), db.to(torch.bfloat16)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(kernels.build(source=SOURCE)))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.sonicsim_bf16_lstm_scan.argtypes = [p] * 10 + [i64] * 5 + [ctypes.c_int, p]
        lib.sonicsim_bf16_lstm_scan_backward.argtypes = [p] * 10 + [i64] * 5 + [ctypes.c_int, p]
        lib.sonicsim_bf16_running_sum.argtypes = [p] * 8 + [ctypes.c_int] + [i64] * 6 + [
            ctypes.c_int, p]
        for fn in (lib.sonicsim_bf16_lstm_scan, lib.sonicsim_bf16_lstm_scan_backward,
                   lib.sonicsim_bf16_running_sum):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, tensors: dict, shapes: dict, dtype=torch.bfloat16) -> torch.device:
    """Every tensor of ``tensors`` has its shape of ``shapes`` and ``dtype``,
    on the first one's device; returns that device."""
    device = next(iter(tensors.values())).device
    for key, t in tensors.items():
        want = dtype[key] if isinstance(dtype, dict) else dtype
        if t.dtype != want or t.device != device:
            raise TypeError(f"{name}: {key} must be {want} on {device}, got {t.dtype} on "
                            f"{t.device}")
        if key in shapes and tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} must be {tuple(shapes[key])}, got "
                             f"{tuple(t.shape)}")
    return device


def _on_card(name: str, device: torch.device, hidden: int, n: int, k: int, width: int) -> None:
    """Raise unless the kernel ``name`` takes these arguments on ``device``."""
    if device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {device}")
    if hidden not in HIDDEN:
        raise ValueError(f"{name}: the kernel takes a hidden width in {HIDDEN}, got {hidden}")
    if n * k * width >= 2**62 or k >= 2**31 or n >= 2**31:
        raise ValueError(f"{name}: N={n}, K={k} too large")


def _mask(reverse: Sequence[bool]) -> int:
    return sum(1 << d for d, r in enumerate(reverse) if r)


def _launched(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")
    LAUNCHES[name] += 1


def bf16_lstm_scan(xp: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
                   h0: torch.Tensor, c0: torch.Tensor, reverse: Sequence[bool],
                   keep: bool = False) -> tuple:
    """flax's bfloat16 LSTM cell over D directions of N sequences of K
    steps, every tensor bfloat16:

    * ``xp`` (N, K, D·4H): each direction's rounded input projection,
      side by side on the last axis;
    * ``w_hh`` (D, 4H, H), torch's gate order (i, f, g, o), and ``bias``
      (D, 4H), flax's one bias per gate;
    * ``h0``, ``c0`` (D, N, H), torch's state layout; ``reverse`` one flag
      per direction: that direction walks from step K − 1 down to 0.

    Returns the outputs (N, K, D·H), ``[direction 0, direction 1]`` on the
    last axis, each at the step that made it, and the final ``(h, c)``,
    each (D, N, H). With ``keep`` (the training variant) also what the
    backward reads: each step's rounded gates i, f, g, o (N, K, D·4H) and
    cells ``c`` (N, K, D·H)."""
    if xp.dim() != 3 or w_hh.dim() != 3:
        raise ValueError(f"xp must be (N, K, D·4H) and w_hh (D, 4H, H), got "
                         f"{tuple(xp.shape)} and {tuple(w_hh.shape)}")
    n, k, width = xp.shape
    dirs, gates, hidden = w_hh.shape
    if gates != 4 * hidden or width != dirs * gates or len(reverse) != dirs:
        raise ValueError(f"xp {tuple(xp.shape)}, w_hh {tuple(w_hh.shape)} and "
                         f"{len(reverse)} reverse flags do not agree")
    device = _check("bf16_lstm_scan", dict(xp=xp, w_hh=w_hh, bias=bias, h0=h0, c0=c0),
                    dict(bias=(dirs, gates), h0=(dirs, n, hidden), c0=(dirs, n, hidden)))
    if device.type == "cpu":
        return bf16_lstm_scan_ref(xp, w_hh, bias, h0, c0, reverse, keep)
    name = "bf16_lstm_scan_train" if keep else "bf16_lstm_scan"
    _on_card(name, device, hidden, n, k, width)
    xp, w_hh, bias, h0, c0 = (t.contiguous() for t in (xp, w_hh, bias, h0, c0))
    y = torch.empty(n, k, dirs * hidden, dtype=torch.bfloat16, device=device)
    gates_out = torch.empty_like(xp) if keep else None
    c = torch.empty_like(y) if keep else None
    kept = (gates_out, c) if keep else ()
    if k == 0:
        return (y, h0.clone(), c0.clone()) + kept
    hn, cn = torch.empty_like(h0), torch.empty_like(c0)
    _launched(name, _library().sonicsim_bf16_lstm_scan(
        xp.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        y.data_ptr(), hn.data_ptr(), cn.data_ptr(), gates_out.data_ptr() if keep else None,
        c.data_ptr() if keep else None, n, k, dirs, hidden, _mask(reverse), device.index,
        torch.cuda.current_stream(device).cuda_stream))
    return (y, hn, cn) + kept


def bf16_lstm_scan_backward(dy: torch.Tensor, dhn: torch.Tensor, dcn: torch.Tensor,
                            gates: torch.Tensor, c: torch.Tensor, w_hh: torch.Tensor,
                            c0: torch.Tensor, reverse: Sequence[bool]) -> tuple:
    """The scan's VJP (:func:`bf16_lstm_scan_backward_ref` is its plain
    version and says what it computes): from the cotangents ``dy`` (N, K,
    D·H), ``dhn``, ``dcn`` (D, N, H) and the training forward's ``gates``
    and ``c``, the gate cotangents ``dz`` (N, K, D·4H) and those of ``h0``
    and ``c0``, all bfloat16."""
    n, k, width = gates.shape
    dirs, g4, hidden = w_hh.shape
    if width != dirs * g4 or g4 != 4 * hidden or len(reverse) != dirs:
        raise ValueError(f"gates {tuple(gates.shape)}, w_hh {tuple(w_hh.shape)} and "
                         f"{len(reverse)} reverse flags do not agree")
    state = (dirs, n, hidden)
    device = _check("bf16_lstm_scan_backward",
                    dict(gates=gates, dy=dy, dhn=dhn, dcn=dcn, c=c, w_hh=w_hh, c0=c0),
                    dict(dy=(n, k, dirs * hidden), c=(n, k, dirs * hidden), dhn=state,
                         dcn=state, c0=state))
    if device.type == "cpu":
        return bf16_lstm_scan_backward_ref(dy, dhn, dcn, gates, c, w_hh, c0, reverse)
    _on_card("bf16_lstm_scan_backward", device, hidden, n, k, width)
    dy, dhn, dcn, gates, c, w_hh, c0 = (t.contiguous()
                                        for t in (dy, dhn, dcn, gates, c, w_hh, c0))
    dz = torch.empty_like(gates)
    if k == 0:
        return dz, dhn.clone(), dcn.clone()
    dh0, dc0 = torch.empty_like(dhn), torch.empty_like(dcn)
    _launched("bf16_lstm_scan_backward", _library().sonicsim_bf16_lstm_scan_backward(
        dy.data_ptr(), dhn.data_ptr(), dcn.data_ptr(), gates.data_ptr(), c.data_ptr(),
        w_hh.data_ptr(), c0.data_ptr(), dz.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), n, k,
        dirs, hidden, _mask(reverse), device.index,
        torch.cuda.current_stream(device).cuda_stream))
    return dz, dh0, dc0


def bf16_running_sum(products: torch.Tensor, dz: torch.Tensor,
                     reverse: Sequence[bool], dw0: torch.Tensor | None = None,
                     db0: torch.Tensor | None = None) -> tuple:
    """The weight and bias gradients accumulated in bfloat16 as the JAX
    scan's transpose loop does (:func:`bf16_running_sum_ref` is the plain
    version): ``products`` (D, K, 4H, M) float32 (:func:`step_products`)
    and ``dz`` (N, K, D·4H), bfloat16 (the bfloat16 cell's) or float32 (a
    float32 carry's), from the accumulators ``dw0`` (D, 4H, M) and ``db0``
    (D, 4H) where given (a walk in chunks of steps) → ``dW`` (D, 4H, M) and
    ``db`` (D, 4H), bfloat16."""
    if products.dim() != 4 or dz.dim() != 3:
        raise ValueError(f"products must be (D, K, 4H, M) and dz (N, K, D·4H), got "
                         f"{tuple(products.shape)} and {tuple(dz.shape)}")
    dirs, k, gates, m = products.shape
    n = dz.shape[0]
    if len(reverse) != dirs:
        raise ValueError(f"{dirs} directions and {len(reverse)} reverse flags")
    if dz.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"bf16_running_sum: dz must be bfloat16 or float32, got {dz.dtype}")
    tensors, dtypes = dict(products=products, dz=dz), dict(products=torch.float32, dz=dz.dtype)
    shapes = dict(dz=(n, k, dirs * gates), dw0=(dirs, gates, m), db0=(dirs, gates))
    for key, t in (("dw0", dw0), ("db0", db0)):
        if t is not None:
            tensors[key], dtypes[key] = t, torch.bfloat16
    device = _check("bf16_running_sum", tensors, shapes, dtypes)
    if device.type == "cpu":
        return bf16_running_sum_ref(products, dz, reverse, dw0, db0)
    if device.type != "cuda":
        raise RuntimeError(f"bf16_running_sum: no kernel for device {device}")
    if products.numel() >= 2**62 or dz.numel() >= 2**62 or n > 51200 or k >= 2**31:
        raise ValueError(f"bf16_running_sum: N={n}, K={k} too large (at most 51,200 rows)")
    if gates % 32:
        raise ValueError(f"bf16_running_sum: 4H={gates} is not a multiple of 32")
    products, dz = products.contiguous(), dz.contiguous()
    dw0, db0 = (None if t is None else t.contiguous() for t in (dw0, db0))
    dw = torch.empty(dirs, gates, m, dtype=torch.bfloat16, device=device)
    db = torch.empty(dirs, gates, dtype=torch.bfloat16, device=device)
    if k == 0 or dw.numel() == 0:
        return (dw.zero_() if dw0 is None else dw.copy_(dw0),
                db.zero_() if db0 is None else db.copy_(db0))
    # Scratch: each step's bias row sums, and a count of finished blocks per
    # 32 columns.
    partial = torch.empty(dirs * gates // 32, k, 32, dtype=torch.float32, device=device)
    counters = torch.zeros(dirs * gates // 32, dtype=torch.int32, device=device)
    f32_dz = dz.dtype == torch.float32
    _launched("bf16_running_sum_f32dz" if f32_dz else "bf16_running_sum",
              _library().sonicsim_bf16_running_sum(
        products.data_ptr(), dz.data_ptr(), None if dw0 is None else dw0.data_ptr(),
        None if db0 is None else db0.data_ptr(), dw.data_ptr(), db.data_ptr(),
        partial.data_ptr(), counters.data_ptr(), int(f32_dz), n, k, dirs, gates, m,
        _mask(reverse), device.index, torch.cuda.current_stream(device).cuda_stream))
    return dw, db


# The most bytes of step products a float32-carry layer's backward holds at
# once: more steps are walked in chunks, the bfloat16 accumulators carried
# from chunk to chunk (exact: they are rounded after every add).
PRODUCTS_BUDGET = 2**31


def running_weight_gradients(dz: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                             h0: torch.Tensor, reverse: Sequence[bool],
                             dz_x: torch.Tensor | None = None) -> tuple:
    """``dW`` (D, 4H, H + C) and ``db`` (D, 4H), bfloat16: the bfloat16
    running sums of :func:`step_products` and of ``dz``'s row sums
    (:func:`bf16_running_sum`), walked in chunks of steps whose products
    fit in :data:`PRODUCTS_BUDGET` bytes."""
    n, k, width = dz.shape
    dirs, _, hidden = h0.shape
    per_step = 4 * width * (hidden + x.shape[-1])
    step = max(1, min(k, PRODUCTS_BUDGET // max(per_step, 1)))
    dw = db = None
    for o0 in range(0, k, step):
        walk = (o0, min(k, o0 + step))
        products = step_products(dz, x, y, h0, reverse, dz_x, walk)
        dw, db = bf16_running_sum(products, walk_chunk(dz, reverse, walk), reverse, dw, db)
        del products
    if dw is None:  # no steps
        dw = torch.zeros(dirs, width // dirs, hidden + x.shape[-1], dtype=torch.bfloat16,
                         device=dz.device)
        db = torch.zeros(dirs, width // dirs, dtype=torch.bfloat16, device=dz.device)
    return dw, db


def _projection(x: torch.Tensor, w_ih: torch.Tensor) -> torch.Tensor:
    """flax's input dense: ``x`` (N, K, C) times each direction's ``w_ih``
    (D, 4H, C), a float32 dot over bfloat16 values rounded to bfloat16,
    (N, K, D·4H)."""
    xf = x.float()
    return torch.cat([(xf @ w.float().t()).to(torch.bfloat16) for w in w_ih], dim=-1)


class _Bf16Lstm(torch.autograd.Function):
    """:func:`bf16_lstm` under autograd: the training forward keeps the
    gates and ``c``; the backward runs the backward scan, the step products and
    the running sum, and ``dx`` as flax's per-step ``rnd(dz_t·W_ih)``
    (one product over all steps, the directions' parts added and rounded)."""

    @staticmethod
    def forward(ctx, x, w_ih, w_hh, bias, h0, c0, reverse):
        y, hn, cn, gates, c = bf16_lstm_scan(_projection(x, w_ih), w_hh, bias, h0, c0, reverse,
                                             keep=True)
        ctx.reverse = reverse
        ctx.save_for_backward(x, w_ih, w_hh, h0, c0, y, gates, c)
        return y, hn, cn

    @staticmethod
    def backward(ctx, dy, dhn, dcn):
        x, w_ih, w_hh, h0, c0, y, gates, c = ctx.saved_tensors
        reverse = ctx.reverse
        dz, dh0, dc0 = bf16_lstm_scan_backward(dy, dhn, dcn, gates, c, w_hh, c0, reverse)
        dw, db = running_weight_gradients(dz, x, y, h0, reverse)
        hidden = w_hh.shape[2]
        n, k, _ = x.shape
        dzs = dz.float().reshape(n, k, len(reverse), -1)
        dx = sum(_rnd(dzs[:, :, d] @ w_ih[d].float()) for d in range(len(reverse)))
        return (_rnd(dx).to(torch.bfloat16), dw[:, :, hidden:], dw[:, :, :hidden], db, dh0, dc0,
                None)


def bf16_lstm(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
              h0: torch.Tensor, c0: torch.Tensor, reverse: Sequence[bool]) -> tuple:
    """flax's bfloat16 ``nn.RNN(OptimizedLSTMCell)`` over D directions, the
    input projection included: ``x`` (N, K, C), ``w_ih`` (D, 4H, C), the
    rest as :func:`bf16_lstm_scan` takes them, all bfloat16. Returns the
    outputs (N, K, D·H) and the final ``(h, c)``. While autograd records,
    the training forward runs and the gradients are the JAX scan's
    (:class:`_Bf16Lstm`); else the inference forward."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, w_ih, w_hh, bias, h0, c0)):
        return _Bf16Lstm.apply(x, w_ih, w_hh, bias, h0, c0, tuple(reverse))
    return bf16_lstm_scan(_projection(x, w_ih), w_hh, bias, h0, c0, reverse)


class _CarryProjection(torch.autograd.Function):
    """The input projection of :func:`f32_carry_lstm`, whose cotangent is
    the gates' ``dz``: its backward computes the layer's weight and bias
    gradients as ``jax.grad`` does (the recurrence it feeds runs with its
    weights detached, so only ``dz`` and the states' cotangents come back
    through it). ``outputs`` is a list the caller appends the layer's
    outputs to once the recurrence has run."""

    @staticmethod
    def forward(ctx, x, w_ih, w_hh, b_ih, b_hh, h0, outputs, reverse):
        xf = x.float()
        parts = [xf @ w.float().t() for w in w_ih]
        if x.dtype != torch.float32:  # flax's input dense on a bfloat16 input
            parts = [_rnd(p) for p in parts]
        ctx.outputs, ctx.reverse = outputs, reverse
        ctx.save_for_backward(x, w_ih, w_hh, h0)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, dz):
        x, w_ih, w_hh, h0 = ctx.saved_tensors
        y = ctx.outputs[0]
        reverse, hidden = ctx.reverse, w_hh.shape[2]
        narrow = x.dtype != torch.float32
        dz = dz.contiguous()
        # flax's bfloat16 input dense reads the rounded cotangent: its product
        # and the input's cotangent are rounded per step.
        dz_x = dz.to(torch.bfloat16) if narrow else None
        dw, db = running_weight_gradients(dz, x, y, h0, reverse, dz_x)
        dx = None
        if ctx.needs_input_grad[0]:
            n, k, _ = x.shape
            lhs = (dz_x if narrow else dz).float().reshape(n, k, len(reverse), -1)
            parts = [lhs[:, :, d] @ w_ih[d].float() for d in range(len(reverse))]
            dx = _rnd(sum(_rnd(p) for p in parts)) if narrow else sum(parts)
            dx = dx.to(x.dtype)
        need = ctx.needs_input_grad
        return (dx, dw[:, :, hidden:], dw[:, :, :hidden], db if need[3] else None,
                db if need[4] else None, None, None, None)


def f32_carry_lstm(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                   b_ih: torch.Tensor, b_hh: torch.Tensor, h0: torch.Tensor,
                   c0: torch.Tensor, reverse: Sequence[bool], train: bool) -> tuple:
    """flax's ``nn.RNN(OptimizedLSTMCell)`` with a float32 carry on bfloat16
    parameters over D directions, while autograd records: the layer a
    bfloat16 train step trains (``make_train_step(precision="bf16")``, the
    JAX package's casting the parameters inside the traced function) where
    the carry is float32. ``x`` (N, K, C) bfloat16 or float32, ``w_ih`` (D,
    4H, C), ``w_hh`` (D, 4H, H), ``b_ih`` and ``b_hh`` (D, 4H) bfloat16 (the
    gates' bias is their float32 sum), ``h0``, ``c0`` (D, N, H) float32.
    Returns the outputs (N, K, D·H) and the final ``(h, c)``, float32.

    The forward is the float32 recurrence (cuDNN's RNN on the card), one
    direction at a time (the reverse one on its projection reversed), on the
    input projection, flax's input dense (rounded to bfloat16 on a bfloat16
    input), fed to it through an identity input weight of 4H. So cuDNN's
    input cotangent is each step's gate cotangent ``dz``, and from it the
    backward computes what the compiled HLO of
    ``jax.vjp`` computes: each weight's gradient a bfloat16 running sum over
    the steps of the rounded float32 per-step products ``dz_tᵀ·h_{t−1}`` and
    ``dz_tᵀ·x_t`` (``rnd(dz_t)ᵀ·x_t`` on a bfloat16 input), the bias's of the
    rounded float32 row sums of ``dz_t`` (:func:`running_weight_gradients`);
    the input's ``dz·W_ih`` (each direction's ``rnd(rnd(dz)·W_ih)`` added
    and rounded, on a bfloat16 input). A float32 running sum, cuDNN's own,
    rounds once instead and lies 3–6e-2 (rel-L2) from JAX's."""
    dirs, gates, _ = w_hh.shape
    outputs = []
    xp = _CarryProjection.apply(x, w_ih, w_hh, b_ih, b_hh, h0, outputs, tuple(reverse))
    eye = torch.eye(gates, dtype=torch.float32, device=x.device)
    ys, hs, cs = [], [], []
    for d, r in enumerate(reverse):
        xd = xp[..., d * gates:(d + 1) * gates]
        flat = [eye, w_hh[d].detach().float(), b_ih[d].detach().float(),
                b_hh[d].detach().float()]
        y, hn, cn = torch._VF.lstm(xd.flip(1) if r else xd, (h0[d:d + 1], c0[d:d + 1]), flat,
                                   True, 1, 0.0, train, False, True)
        ys.append(y.flip(1) if r else y)
        hs.append(hn)
        cs.append(cn)
    y = torch.cat(ys, dim=-1) if dirs > 1 else ys[0]
    outputs.append(y.detach())
    return y, torch.cat(hs), torch.cat(cs)
