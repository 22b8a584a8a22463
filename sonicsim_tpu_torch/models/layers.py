"""Shared neural layers (norms, activations) of the port's models.

Port of ``sonicsim_tpu.models.layers`` in the reference's (B, C, T) layout,
with the reference's parameter names and shapes (ConvTasnet.py:10-87), so a
reference ``state_dict`` loads as it is. Every layer computes in the dtype
of its input: a bfloat16 module on a bfloat16 input takes its statistics in
bfloat16 too, as the JAX package's ``bf16_forward`` does.

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
    """torch.nn.PReLU with one shared slope, init 0.25 (parameter ``weight``)."""

    def __init__(self, init: float = 0.25):
        super().__init__(num_parameters=1, init=init)


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


class GroupedConv1D(nn.Conv1d):
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
