"""Shared blocks of the separation zoo.

Port of ``sonicsim_tpu.models.zoo_layers`` (reference
separation/look2hear/models/{sudormrf,afrcnn,TDANet}.py GlobLN /
ConvNormAct / DilatedConvNorm, dprnn.py:70-165 dual-path chunking and RNN
blocks, bsrnn.py:6-48 ResRNN), under the reference's parameter names so a
reference ``state_dict`` loads as it is. Convolutions are ``nn.Conv1d``
(``groups=`` for the grouped and depthwise ones) on (B, C, T); the
recurrent blocks work on channel-last (B, T, C), as ``nn.LSTM`` reads it.

LSTMs. ``LSTMLayer`` is ``nn.LSTM(batch_first=True)`` returning the
output sequence alone; a bidirectional one concatenates [forward,
backward] along the channels, as flax's ``nn.Bidirectional`` does. The JAX
package's ``OptimizedLSTMCell`` keeps per-gate denses (gates i, f, g, o)
and one bias per gate, equal to torch's ``bias_ih + bias_hh``; ``bridge``
carries that bias into ``bias_ih`` and zeros into ``bias_hh``, so weights
cross flax→torch→flax exactly and torch→flax→torch as the same function.
On the card ``nn.LSTM`` runs cuDNN's RNN, whose float32 is full float32
only with ``torch.backends.cudnn.allow_tf32`` off (``scripts.common
.strict_float32``). Its forward agrees with the CPU's to about 1e-6 of the
output; its gradients lie further from float64 than the CPU's float32 ones
(ROADMAP C12).

No block applies dropout: the JAX models never do, in training either.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import PReLU

F32_EPS = 1.1920929e-7  # torch.finfo(torch.float32).eps: GroupNorm1's epsilon


def ignore_on_load(module: nn.Module, *names: str) -> None:
    """Let ``load_state_dict`` skip the entries ``names`` of ``module``: the
    constant tables a reference checkpoint carries as buffers (positional
    encodings, inverse frequencies), which the port computes as the JAX
    package does instead of reading them."""
    def hook(mod, state_dict, prefix, *args):
        for name in names:
            state_dict.pop(prefix + name, None)

    module.register_load_state_dict_pre_hook(hook)


class PrefixTable:
    """Rows ``[0, n)`` of a constant table whose rows do not depend on ``n``
    (positional encodings), made by ``make(n)`` as float32 numpy. One table
    is kept, for the longest ``n`` asked for and the last device, so serving
    spans of many lengths costs one table, not one per length."""

    def __init__(self, make):
        self.make, self.rows = make, None

    def __call__(self, n: int, device) -> torch.Tensor:
        rows = self.rows
        if rows is None or rows.shape[0] < n or rows.device != torch.device(device):
            longest = max(n, 0 if rows is None else rows.shape[0])
            self.rows = rows = torch.from_numpy(self.make(longest)).to(device)
        return rows[:n]


class GlobLN(nn.Module):
    """gLN over (C, T) per sample on (B, C, T), ``gamma``/``beta`` of shape
    (C,) (the zoo's GlobLN; ``layers.GlobalLayerNorm`` keeps ConvTasNet's
    (C, 1)). Epsilon 1e-8 in the zoo's blocks, 1e-5 where the JAX models
    take ``GlobalLayerNorm``'s default."""

    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        centred = x - x.mean(dim=(1, 2), keepdim=True)
        var = (centred * centred).mean(dim=(1, 2), keepdim=True)
        return self.gamma[:, None] * centred * torch.rsqrt(var + self.eps) + self.beta[:, None]


class GroupNorm1(nn.Module):
    """``nn.GroupNorm(1, C)``: statistics over the channels and every other
    non-batch axis, per-channel affine (``weight``, ``bias``). On (B, C, ...)
    or, with ``channel_last``, on (B, ..., C)."""

    def __init__(self, dim: int, eps: float = F32_EPS, channel_last: bool = False):
        super().__init__()
        self.eps, self.channel_last = eps, channel_last
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.channel_last:
            x = x.movedim(-1, 1)
        y = F.group_norm(x, 1, self.weight, self.bias, self.eps)
        return y.movedim(1, -1) if self.channel_last else y


class StatelessBatchNorm(nn.Module):
    """Batch statistics over every non-channel axis of a channel-last tensor
    with a per-channel affine (``weight``, ``bias``), no running statistics;
    with ``use_running_stats`` the frozen ``running_mean``/``running_var``
    of an eval-mode ``BatchNorm`` instead."""

    def __init__(self, dim: int, eps: float = 1e-5, use_running_stats: bool = False):
        super().__init__()
        self.eps, self.use_running_stats = eps, use_running_stats
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        if use_running_stats:
            self.register_buffer("running_mean", torch.zeros(dim))
            self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_running_stats:
            mu, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            mu = x.mean(dim=axes, keepdim=True)
            var = x.var(dim=axes, keepdim=True, unbiased=False)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def _conv(nin: int, nout: int, k: int, stride: int, dilation: int, groups: int,
          bias: bool) -> nn.Conv1d:
    """The zoo's conv: the symmetric torch pad ``dilation·(k − 1)//2``
    (sudormrf.py:62, :129)."""
    return nn.Conv1d(nin, nout, k, stride=stride, padding=dilation * ((k - 1) // 2),
                     dilation=dilation, groups=groups, bias=bias)


class ConvNormAct(nn.Module):
    """Conv1d + gLN + PReLU (sudormrf.py:47-71): ``conv``, ``norm``, ``act``."""

    def __init__(self, nin: int, nout: int, kernel_size: int, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.conv = _conv(nin, nout, kernel_size, stride, 1, groups, True)
        self.norm = GlobLN(nout)
        self.act = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


class ConvNorm(nn.Module):
    """Conv1d + gLN, no activation (sudormrf.py:73-94): ``conv``, ``norm``."""

    def __init__(self, nin: int, nout: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.conv = _conv(nin, nout, kernel_size, stride, 1, groups, bias)
        self.norm = GlobLN(nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class NormAct(nn.Module):
    """gLN + PReLU (sudormrf.py:96-112): ``norm``, ``act``."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = GlobLN(dim)
        self.act = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(x))


class DilatedConvNorm(nn.Module):
    """Dilated (depthwise) conv + gLN (sudormrf.py:135-156): ``conv``,
    ``norm``."""

    def __init__(self, nin: int, nout: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1):
        super().__init__()
        self.conv = _conv(nin, nout, kernel_size, stride, dilation, groups, True)
        self.norm = GlobLN(nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class LSTMLayer(nn.LSTM):
    """A uni- or bidirectional LSTM over axis 1 of (B, T, C) →
    (B, T, H · directions), zero initial state: one layer, or a stack of
    ``num_layers`` (the enhancement models' ``SequenceModel``).

    ``bias_hh`` is frozen (``requires_grad=False``): flax's cell has one bias
    per gate, ``bias_ih + bias_hh`` here, so training moves ``bias_ih``
    alone. With both trainable, Adam would move the sum twice as far and the
    global-norm clip would count its gradient twice; frozen, the train step
    is optax's. A reference checkpoint's ``bias_hh`` still loads and adds
    in."""

    def __init__(self, input_size: int, hidden: int, bidirectional: bool = False,
                 num_layers: int = 1):
        super().__init__(input_size, hidden, num_layers=num_layers, batch_first=True,
                         bidirectional=bidirectional)
        for name, p in self.named_parameters():
            if name.startswith("bias_hh"):
                p.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return super().forward(x)[0]

    def run(self, x: torch.Tensor, hx=None):
        """``nn.LSTM``'s own call: ``(output, (h_n, c_n))`` from the initial
        state ``hx = (h_0, c_0)``, each (directions, B, H), or zeros."""
        return super().forward(x, hx)


class ResRNN(nn.Module):
    """Residual norm → BLSTM → projection (bsrnn.py:6-26) on (B, T, C):
    ``norm``, ``rnn``, ``proj``."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = True):
        super().__init__()
        self.norm = GroupNorm1(input_size, channel_last=True)
        self.rnn = LSTMLayer(input_size, hidden_size, bidirectional)
        self.proj = nn.Linear(hidden_size * (2 if bidirectional else 1), input_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.proj(self.rnn(self.norm(x)))


# --- dual-path chunking (dprnn.py:260-318 semantics, channel-last) ---------


def segment_sequence(x: torch.Tensor, chunk: int) -> tuple[torch.Tensor, int]:
    """(B, T, N) → (B, S, K, N) chunks of ``chunk`` frames at 50% overlap,
    and the ``gap`` of zeros appended to T (the JAX package's formula,
    ``chunk − (chunk//2 + T mod chunk) mod chunk``)."""
    b, t, n = x.shape
    p = chunk // 2
    gap = chunk - (p + t % chunk) % chunk
    x = F.pad(x, (0, 0, p, p + gap))
    t_pad = x.shape[1]
    seg1 = x[:, : t_pad - p].reshape(b, -1, chunk, n)
    seg2 = x[:, p:].reshape(b, -1, chunk, n)
    return torch.stack([seg1, seg2], dim=2).reshape(b, -1, chunk, n), gap


def overlap_add_sequence(x: torch.Tensor, gap: int) -> torch.Tensor:
    """(B, S, K, N) → (B, T, N): the inverse of :func:`segment_sequence`."""
    b, s, k, n = x.shape
    p = k // 2
    x = x.reshape(b, -1, 2 * k, n)
    x1 = x[:, :, :k].reshape(b, -1, n)[:, p:]
    x2 = x[:, :, k:].reshape(b, -1, n)[:, :-p]
    out = x1 + x2
    return out[:, :-gap] if gap > 0 else out


class DualRNNBlock(nn.Module):
    """Intra-chunk then inter-chunk RNN, each with a projection, a
    GroupNorm(1) and a residual (dprnn.py:70-165), on (B, S, K, N)."""

    def __init__(self, out_channels: int, hidden_channels: int, bidirectional: bool = False):
        super().__init__()
        width = hidden_channels * (2 if bidirectional else 1)
        self.intra_rnn = LSTMLayer(out_channels, hidden_channels, bidirectional)
        self.intra_linear = nn.Linear(width, out_channels)
        self.intra_norm = GroupNorm1(out_channels, channel_last=True)
        self.inter_rnn = LSTMLayer(out_channels, hidden_channels, bidirectional)
        self.inter_linear = nn.Linear(width, out_channels)
        self.inter_norm = GroupNorm1(out_channels, channel_last=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, k, n = x.shape
        intra = self.intra_linear(self.intra_rnn(x.reshape(b * s, k, n)))
        x = x + self.intra_norm(intra.reshape(b, s, k, n))
        inter = x.transpose(1, 2).reshape(b * k, s, n)
        inter = self.inter_linear(self.inter_rnn(inter)).reshape(b, k, s, n)
        return x + self.inter_norm(inter.transpose(1, 2))
