"""Shared neural layers (norms, activations) of the port's models.

Port of ``sonicsim_tpu.models.layers`` in the reference's (B, C, T) layout,
with the reference's parameter names and shapes (ConvTasnet.py:10-87), so a
reference ``state_dict`` loads as it is.

Mixed precision follows JAX's type promotion, as the JAX package's
``bf16_forward`` meets it (``infer.precision``): a layer with weights
computes in ``torch.promote_types(input, weight)`` (flax's
``promote_dtype``), casting the weights up, never the input down, so a
float32 input meeting bfloat16 weights (after an LSTM or an STFT) computes
in float32 on bfloat16-rounded weights. ``Linear``, ``Conv1d``, ``Conv2d``,
``ConvTranspose1d``, ``ConvTranspose2d`` and ``PReLU`` are torch's layers
under that rule, with torch's parameter names. ``LayerNorm`` and
``GroupNorm`` are flax's built-in norms: statistics in float32 (or the
input's dtype where that is wider), output in the promoted dtype. The
hand-written norms (gLN, cLN) compute as the JAX ones do, in the dtype of
their input: their reductions of bfloat16 accumulate in float32 and round
to bfloat16, as ``jnp.mean`` does. In float32 every rule here is the
identity.

``GroupedConv1D`` is the JAX package's grouped/depthwise conv with its
padding rules; the JAX module computes the depthwise case as shifted
multiply-adds (the grouped lowering was slow on the TPU), the port as
``nn.Conv1d(groups=)``, with the same parameters (``bridge``'s Conv1d map).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.lstm_cell import row_sum_ref


def promote(*tensors):
    """``tensors`` (``None`` passes) cast to the widest of their dtypes by
    ``torch.promote_types``: flax's ``promote_dtype``."""
    dtype = None
    for t in tensors:
        if t is not None:
            dtype = t.dtype if dtype is None else torch.promote_types(dtype, t.dtype)
    return [t if t is None or t.dtype == dtype else t.to(dtype) for t in tensors]


def float32_or_wider(dtype: torch.dtype) -> torch.dtype:
    """The dtype flax's built-in norms take statistics in
    (``force_float32_reductions``), and a float32 constant table promotes to:
    float32, or ``dtype`` where that is wider."""
    return torch.promote_types(dtype, torch.float32)


class Linear(nn.Linear):
    """flax's ``Dense`` in the promoted dtype. Below float32 the product is
    rounded before the bias is added, as XLA computes flax's ``dot_general``
    and then ``y + bias``, each rounded; ``F.linear`` with the bias would
    round once."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        x, w, b = promote(x, self.weight, self.bias)
        if b is None or float32_or_wider(x.dtype) == x.dtype:
            return F.linear(x, w, b)
        return F.linear(x, w) + b

    def unrounded(self, x: torch.Tensor) -> torch.Tensor | None:
        """The float32 value :meth:`forward` rounds below float32 (the
        rounded product plus the bias, the product taken again), or None
        where it rounds nothing."""
        x, w, b = promote(x, self.weight, self.bias)
        if b is None or float32_or_wider(x.dtype) == x.dtype:
            return None
        return F.linear(x, w).float() + b.float()


class Conv1d(nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return self._conv_forward(*promote(x, self.weight, self.bias))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return self._conv_forward(*promote(x, self.weight, self.bias))


class ConvTranspose1d(nn.ConvTranspose1d):
    """With the constructor's ``output_padding`` (no ``output_size``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        x, w, b = promote(x, self.weight, self.bias)
        return F.conv_transpose1d(x, w, b, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class ConvTranspose2d(nn.ConvTranspose2d):
    """With the constructor's ``output_padding`` (no ``output_size``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        x, w, b = promote(x, self.weight, self.bias)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class MultiheadAttention(nn.MultiheadAttention):
    """torch's attention (``batch_first``, packed in-projection, no mask)
    in the dtype of the query promoted with the weights (flax's
    ``MultiHeadDotProductAttention``). Below float32 it is computed as XLA
    computes flax's (:func:`flax_attention`), with no dropout, as the JAX
    models call it."""

    def forward(self, query, key, value, need_weights: bool = False):  # type: ignore[override]
        weights = (self.in_proj_weight, self.in_proj_bias, self.out_proj.weight,
                   self.out_proj.bias)
        dtype = promote(query, *weights)[0].dtype
        if float32_or_wider(dtype) != dtype:
            q, k, v = (t.to(dtype) for t in (query, key, value))
            w_in, b_in, w_out, b_out = (None if t is None else t.to(dtype) for t in weights)
            out, attn = flax_attention(q, k, v, self.num_heads, w_in, b_in, w_out, b_out)
            return out, attn.mean(dim=1) if need_weights else None
        if all(t is None or t.dtype == dtype for t in (query, key, value) + weights):
            return super().forward(query, key, value, need_weights=need_weights)
        q, k, v = (t.to(dtype).transpose(0, 1) for t in (query, key, value))
        w_in, b_in, w_out, b_out = (None if t is None else t.to(dtype) for t in weights)
        out, attn = F.multi_head_attention_forward(
            q, k, v, self.embed_dim, self.num_heads, w_in, b_in, None, None, False, 0.0,
            w_out, b_out, training=self.training, need_weights=need_weights)
        return out.transpose(0, 1), attn


def _dense(x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """flax's ``Dense``/``DenseGeneral``: the product, then the bias, each
    rounded to ``x``'s dtype."""
    y = F.linear(x, w)
    return y if b is None else y + b


def flax_attention(query, key, value, heads: int, w_in, b_in, w_out, b_out) -> tuple:
    """flax's ``MultiHeadDotProductAttention`` on (B, L, E) operands of one
    narrow dtype, with torch's packed weights (``in_proj`` [q; k; v],
    ``out_proj``): ``(out (B, L, E), weights (B, heads, L, S))``. Each op
    is rounded to that dtype where the compiled JAX forward rounds it
    (flax/linen/attention.py: the denses' product and bias, ``q / √d``,
    ``q·kᵀ``, ``w·v``). jax.nn.softmax's HLO rounds ``x − max``; its
    ``exp`` reaches the float32 sum unrounded (XLA drops the round trip
    ``jnp.sum``'s upcast would make) and the quotient rounded, over the
    rounded sum."""
    e = query.shape[-1]
    depth = e // heads
    wq, wk, wv = w_in.chunk(3)
    bq, bk, bv = (None,) * 3 if b_in is None else b_in.chunk(3)
    q = _dense(query, wq, bq).unflatten(-1, (heads, depth))
    k = _dense(key, wk, bk).unflatten(-1, (heads, depth))
    v = _dense(value, wv, bv).unflatten(-1, (heads, depth))
    q = q / torch.tensor(depth, dtype=torch.float32).sqrt().to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    unnormalised = torch.exp((logits - logits.amax(dim=-1, keepdim=True)).float())
    total = unnormalised.sum(dim=-1, keepdim=True).to(logits.dtype)
    weights = unnormalised.to(logits.dtype) / total
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v).flatten(-2)
    return _dense(out, w_out, b_out), weights


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm`` (torch's parameters): statistics in
    :func:`float32_or_wider`, output in the promoted dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        out = promote(x, self.weight, self.bias)[0].dtype
        s = float32_or_wider(out)
        w, b = (None if p is None else p.to(s) for p in (self.weight, self.bias))
        return F.layer_norm(x.to(s), self.normalized_shape, w, b, self.eps).to(out)


def fused_norm(x: torch.Tensor, unrounded: torch.Tensor, dims, weight, bias,
               eps: float) -> torch.Tensor:
    """flax's ``GroupNorm``/``LayerNorm`` (statistics over ``dims``, the
    affine on the last axis) of a ``x`` narrower than float32, as XLA
    computes it where it fuses the op that made ``x`` into the
    normalisation: the statistics of ``x`` as rounded, the normalisation of
    ``unrounded``, that op's float32 result. Output in ``x``'s dtype."""
    xs = x.float()
    mean = xs.mean(dim=dims, keepdim=True)
    var = (xs - mean).square().mean(dim=dims, keepdim=True)
    y = (unrounded.float() - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def channel_norm_narrow(x: torch.Tensor, unrounded: torch.Tensor | None, weight, bias,
                        eps: float) -> torch.Tensor:
    """The JAX package's hand-written cLN (``gamma·(x − mean)·rsqrt(var +
    eps) + beta`` over the last axis, sonicsim_tpu/models/layers.py:42-47)
    on a ``x`` narrower than float32, as XLA's compiled CPU forward
    computes it: each op in float32 on its operands and rounded to ``x``'s
    dtype, the two means float32 sums times the float32 reciprocal of the
    width, the square unrounded inside its sum, and ``eps`` the narrow
    dtype's. Where XLA fuses the op that made ``x`` into the norm
    (``unrounded``, that op's float32 result), the mean's sum reads it
    unrounded; everything after reads ``x``. Output in ``x``'s dtype."""
    dt = x.dtype
    centred, scale, _ = _channel_stats_narrow(x, unrounded, eps)
    y = _round_to(weight.float() * centred, dt) if weight is not None else centred
    y = _round_to(y * scale, dt)
    if bias is not None:
        y = _round_to(y + bias.float(), dt)
    return y.to(dt)


def _round_to(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return t.to(dt).float()


def _rnd(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _channel_stats_narrow(x: torch.Tensor, unrounded: torch.Tensor | None, eps: float):
    """:func:`channel_norm_narrow`'s ``x − mean``, its ``rsqrt(var + eps)``
    and ``var + eps``, each rounded to ``x``'s dtype, in float32."""
    dt = x.dtype
    inv_n = torch.tensor(1.0 / x.shape[-1], dtype=torch.float32)
    src = x if unrounded is None else unrounded
    mean = _round_to(src.float().sum(dim=-1, keepdim=True) * inv_n, dt)
    centred = _round_to(x.float() - mean, dt)
    var = _round_to((centred * centred).sum(dim=-1, keepdim=True) * inv_n, dt)
    shifted = _round_to(var + _round_to(torch.tensor(eps, dtype=torch.float32), dt), dt)
    return centred, _round_to(torch.rsqrt(shifted), dt), shifted


class _DenseNormBf16(torch.autograd.Function):
    """flax's bfloat16 ``Dense`` followed by SkiM's norm (GroupNorm(1) over
    every non-batch axis, or the JAX cLN over the last), forward as
    :class:`Linear` and :func:`fused_norm` / :func:`channel_norm_narrow`
    compute it, backward as the compiled HLO of ``jax.vjp`` of the pair
    computes it (tests/bf16_dense_norm_hlo.py prints that HLO). With
    ``rnd`` a rounding to bfloat16, ``c`` the output's cotangent, ``u`` the
    Dense's float32 sum of its rounded product and bias and ``y = rnd(u)``:

    * GroupNorm(1): per sample, from ``y``'s float32 sums ``s1``, ``s2`` (the
      mean ``m = s1/n``, ``var = max(s2/n − m², 0)``, ``r = rsqrt(var + eps)``),
      in float32: ``a = Σ c·r·γ``, ``S = Σ_rows (u − m)·c`` per channel,
      ``b = Σ_ch S·γ·(−r/2(var + eps))``; the Dense's cotangent
      ``rnd(rnd(c·r·γ) + rnd((−a − 2m·b)/n + y·2b/n))``; ``dγ = rnd(Σ r·S)``
      and ``dβ = rnd(Σ c)``, float32 sums rounded once;
    * the cLN: every op of its VJP rounded, its channel sums and the
      parameters' row sums bfloat16 reduces;
    * the Dense: the bias's cotangent a bfloat16 reduce over the rows, the
      kernel's and the input's float32 dots rounded once.

    A bfloat16 reduce sums in XLA's order (``ops.lstm_cell.row_sum_ref``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, gamma, beta, eps: float, causal: bool):
        product = F.linear(x, weight)
        unrounded = product.float() + bias.float()
        y = product + bias
        if causal:
            out = channel_norm_narrow(y, unrounded, gamma, beta, eps)
        else:
            out = fused_norm(y, unrounded, tuple(range(1, y.dim())), gamma, beta, eps)
        ctx.save_for_backward(x, weight, bias, gamma, product)
        ctx.eps, ctx.causal = eps, causal
        return out

    @staticmethod
    def backward(ctx, ct):
        x, weight, bias, gamma, product = ctx.saved_tensors
        dt = x.dtype
        u = product.float() + bias.float()
        norm = _cln_backward_bf16 if ctx.causal else _gln_backward_bf16
        d_dense, d_gamma, d_beta = norm(ct.float(), u, gamma.float(), ctx.eps)
        d_bias = row_sum_ref(d_dense.to(dt), lead=d_dense.dim() - 1)
        d_weight = d_dense.flatten(0, -2).t() @ x.float().flatten(0, -2)
        d_x = d_dense @ weight.float()
        return (d_x.to(dt), d_weight.to(dt), d_bias.to(dt), d_gamma.to(dt), d_beta.to(dt),
                None, None)


def _gln_backward_bf16(c: torch.Tensor, u: torch.Tensor, gamma: torch.Tensor, eps: float):
    """GroupNorm(1)'s part of :class:`_DenseNormBf16`'s backward: the
    Dense's cotangent (bfloat16 values) and ``dγ``, ``dβ`` (rounded)."""
    y = _rnd(u)
    per_sample = tuple(range(1, c.dim()))
    inv_n = torch.tensor(1.0 / y[0].numel(), dtype=torch.float32)
    twice = inv_n * 2
    s1 = y.sum(dim=per_sample, keepdim=True)
    raw = y.square().sum(dim=per_sample, keepdim=True) * inv_n - (s1 * inv_n).square()
    var = raw.clamp_min(0.0)
    r = torch.rsqrt(var + eps)
    slope = torch.where(raw > 0, 1.0, torch.where(raw == 0, 0.5, 0.0))
    scale = r * gamma
    a = (c * scale).sum(dim=per_sample, keepdim=True)
    s = ((u - s1 * inv_n) * c).sum(dim=per_sample[:-1], keepdim=True)
    b = (s * gamma * (r / (var + eps) * -0.5)).sum(dim=-1, keepdim=True) * slope
    g1 = (-a + -b * (s1 * twice)) * inv_n
    d_dense = _rnd(_rnd(c * scale) + _rnd(g1 + y * (b * twice)))
    d_gamma = (r * s).sum(dim=tuple(range(c.dim() - 1))).to(torch.bfloat16)
    d_beta = c.sum(dim=tuple(range(c.dim() - 1))).to(torch.bfloat16)
    return d_dense, d_gamma, d_beta


def _cln_backward_bf16(c: torch.Tensor, u: torch.Tensor, gamma: torch.Tensor, eps: float):
    """The cLN's part of :class:`_DenseNormBf16`'s backward (the compiled
    ``jax.vjp`` of sonicsim_tpu/models/layers.py:42-47 on a bfloat16 input):
    the Dense's cotangent (bfloat16 values) and ``dγ``, ``dβ``."""
    bf16, rnd = torch.bfloat16, _rnd
    centred, scale, shifted = _channel_stats_narrow(u.to(bf16), u, eps)
    inv_n = torch.tensor(1.0 / c.shape[-1], dtype=torch.float32)
    lead = c.dim() - 1

    def over_channels(t):
        return row_sum_ref(t.to(bf16).movedim(-1, 0))[..., None]

    d_beta = row_sum_ref(c.to(bf16), lead=lead)
    d_y1 = rnd(c * scale)
    d_scale = over_channels(rnd(rnd(gamma * centred) * c))
    d_gamma = row_sum_ref(rnd(d_y1 * centred).to(bf16), lead=lead)
    d_square = rnd(d_scale * rnd(rnd(scale / shifted) * -0.5) * inv_n)
    from_square = rnd(d_square * rnd(centred * 2))
    direct = rnd(gamma * d_y1)
    d_mean = rnd((over_channels(-direct) + over_channels(-from_square)) * inv_n)
    return rnd(rnd(direct + from_square) + d_mean), d_gamma, d_beta


def dense_norm_bf16(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                    causal: bool) -> torch.Tensor:
    """SkiM's ``norm(proj(x))`` with every operand bfloat16: the output of
    :class:`Linear` and :func:`fused_norm` (GroupNorm(1) over every
    non-batch axis) or :func:`channel_norm_narrow` (``causal``), and the
    gradients ``jax.grad`` computes for the pair (:class:`_DenseNormBf16`)."""
    return _DenseNormBf16.apply(x, weight, bias, gamma, beta, eps, causal)


def group_norm(x: torch.Tensor, groups: int, weight, bias, eps: float) -> torch.Tensor:
    """flax's ``nn.GroupNorm`` on (B, C, ...): ``F.group_norm`` with its
    statistics in :func:`float32_or_wider`, output in the promoted dtype."""
    out = promote(x, weight, bias)[0].dtype
    s = float32_or_wider(out)
    w, b = (None if p is None else p.to(s) for p in (weight, bias))
    return F.group_norm(x.to(s), groups, w, b, eps).to(out)


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm`` (torch's parameters), by :func:`group_norm`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return group_norm(x, self.num_groups, self.weight, self.bias, self.eps)


class GlobalLayerNorm(nn.Module):
    """gLN: normalise over (C, T) jointly, per sample (ConvTasnet.py:34-67).
    ``gamma`` and ``beta`` are (C, 1), as in the reference."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim, 1))
        self.beta = nn.Parameter(torch.zeros(dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, T)
        centred = x - x.mean(dim=(1, 2), keepdim=True)
        var = (centred**2).mean(dim=(1, 2), keepdim=True)
        return self.gamma * centred * torch.rsqrt(var + self.eps) + self.beta


class ChannelLayerNorm(nn.Module):
    """cLN: per-frame LayerNorm over channels (ConvTasnet.py:10-31). The
    reference's cLN is an ``nn.LayerNorm``, so its parameters are ``weight``
    and ``bias`` of shape (C,)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, T)
        centred = x - x.mean(dim=1, keepdim=True)
        var = (centred**2).mean(dim=1, keepdim=True)
        return (self.weight[:, None] * centred * torch.rsqrt(var + self.eps)
                + self.bias[:, None])


def select_norm(norm: str, dim: int) -> nn.Module:
    if norm == "gLN":
        return GlobalLayerNorm(dim)
    if norm == "cLN":
        return ChannelLayerNorm(dim)
    raise ValueError(f"unsupported norm {norm!r} (gLN/cLN)")


class PReLU(nn.PReLU):
    """torch.nn.PReLU, by default with one shared slope, init 0.25
    (parameter ``weight``), in the promoted dtype."""

    def __init__(self, num_parameters: int = 1, init: float = 0.25):
        super().__init__(num_parameters=num_parameters, init=init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return F.prelu(*promote(x, self.weight))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def get_layer(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """String → activation (the reference's utils ``get_layer``)."""
    return get_activation(name)


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    table = {
        "relu": torch.relu,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "gelu": _gelu,
        "softmax": lambda x: torch.softmax(x, dim=-1),
        "linear": lambda x: x,
    }
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"unsupported activation {name!r}") from None


class GroupedConv1D(Conv1d):
    """``nn.Conv1d(groups=)`` on (B, C, T) with the JAX ``GroupedConv1D``'s
    padding: an explicit ``(left, right)`` pair, ``"VALID"`` or ``"SAME"``
    (at stride 1, the extra sample on the right)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding="SAME", dilation: int = 1, groups: int = 1,
                 bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         dilation=dilation, groups=groups, bias=bias)
        eff = dilation * (kernel_size - 1)
        if padding == "VALID":
            self.pad_lr = (0, 0)
        elif padding == "SAME" and stride == 1:
            self.pad_lr = (eff // 2, eff - eff // 2)
        elif isinstance(padding, (tuple, list)) and len(padding) == 2:
            self.pad_lr = tuple(int(p) for p in padding)
        else:
            raise ValueError(f"GroupedConv1D padding {padding!r}: a (left, right) pair, "
                             "'VALID', or 'SAME' at stride 1")

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return super().forward(F.pad(x, self.pad_lr))
