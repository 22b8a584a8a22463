"""TDANet (top-down attention UNet separation) in PyTorch.

Port of ``sonicsim_tpu.models.tdanet`` (reference
separation/look2hear/models/TDANet.py:199-557; config
configs/separation/tdanet.yaml: depth 5, a 2 ms encoder kernel of 32
samples at stride k/4): multi-scale depthwise downsampling, a transformer
block over the sum of the levels average-pooled to the coarsest one,
sigmoid injection back up, one block applied ``num_blocks`` times with the
bottleneck gated back in.

Two modes, as in the JAX package, both under the reference's names
(``sm.unet.globalatt.attn.{attn_in_norm,attn,norm}``, the attention an
``nn.MultiheadAttention``):

* ``torch_compat=False`` (the default) runs the intended temporal
  multi-head self-attention, 8 heads over the pooled frames, the JAX
  package's ``MultiHeadDotProductAttention`` (scale 1/sqrt(head width),
  softmax over the keys);
* ``torch_compat=True`` is the reference checkpoints' quirk: the reference
  feeds (B, T, C) to an attention that expects (T, B, C), so it attends
  over the batch axis, which at batch 1 is the value projection followed
  by the output projection (TDANet.py:251-258). The JAX package computes
  that chain at every batch size; so does the port, from the value rows
  of ``in_proj_weight``. Reference checkpoints load in this mode
  (``models.from_pretrain``).

The reference's quirks stay: the attention's residual adds its own output
to itself before the norm, and the decode chain starts from
``fused[i − 1]``. The positional table is computed in float64 and rounded
to float32, as the JAX package does; a reference checkpoint's ``pe``
buffer is skipped on load.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import BaseModel, register_model
from .layers import PReLU
from .sudormrf import fit_length, masked_decode, nearest_resize
from .zoo_layers import ConvNorm, ConvNormAct, DilatedConvNorm, GlobLN, PrefixTable, ignore_on_load

N_HEAD = 8


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """``F.adaptive_avg_pool1d`` of the last axis with the JAX package's
    windows: frame i averages ``[floor(i·T/n), ceil((i+1)·T/n))``, through
    a running sum (tdanet.py:29-38)."""
    t = x.shape[-1]
    starts = np.floor(np.arange(out_size) * t / out_size).astype(np.int64)
    ends = np.ceil((np.arange(out_size) + 1) * t / out_size).astype(np.int64)
    csum = F.pad(torch.cumsum(x, dim=-1), (1, 0))
    width = torch.from_numpy((ends - starts).astype(np.float32)).to(x.device)
    return (csum[..., ends] - csum[..., starts]) / width


def positional_table(t: int, dim: int) -> np.ndarray:
    """The sinusoidal table of TDANet.py:220-239 for ``t`` frames, float64
    rounded to float32."""
    pos = np.zeros((t, dim), np.float32)
    position = np.arange(t)[:, None]
    div = np.exp(np.arange(0, dim, 2) * -(math.log(10000.0) / dim))
    pos[:, 0::2] = np.sin(position * div)
    pos[:, 1::2] = np.cos(position * div[: dim - dim // 2])
    return pos


class _PositionalAttention(nn.Module):
    def __init__(self, dim: int, torch_compat: bool):
        super().__init__()
        self.dim, self.torch_compat = dim, torch_compat
        self.attn_in_norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = nn.MultiheadAttention(dim, N_HEAD, batch_first=True)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self._table = PrefixTable(lambda t: positional_table(t, dim))
        ignore_on_load(self, "pe")

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, C)
        h = self.attn_in_norm(x) + self._table(x.shape[1], x.device).to(x.dtype)
        c = self.dim
        if self.torch_compat:
            a = F.linear(h, self.attn.in_proj_weight[2 * c:], self.attn.in_proj_bias[2 * c:])
            a = self.attn.out_proj(a)
        else:
            a = self.attn(h, h, h, need_weights=False)[0]
        return self.norm(a + a)


class _Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = ConvNorm(dim, 2 * dim, 1, bias=False)
        self.dwconv = nn.Conv1d(2 * dim, 2 * dim, 5, padding=2, groups=2 * dim)
        self.fc2 = ConvNorm(2 * dim, dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.dwconv(self.fc1(x))))


class GlobalAttention(nn.Module):
    """Transformer block: multi-head self-attention and a conv MLP
    (TDANet.py:199-271), on (B, C, T)."""

    def __init__(self, dim: int, torch_compat: bool = False):
        super().__init__()
        self.attn = _PositionalAttention(dim, torch_compat)
        self.mlp = _Mlp(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x.transpose(1, 2)).transpose(1, 2)
        return x + self.mlp(x)


class Injection(nn.Module):
    """InjectionMulti[Sum] (TDANet.py:273-324): local features gated by the
    resized sigmoid of global ones, plus (``with_sum``) their resized
    embedding."""

    def __init__(self, dim: int, kernel: int = 1, with_sum: bool = False):
        super().__init__()
        self.with_sum = with_sum
        self.local_embedding = ConvNorm(dim, dim, kernel, groups=dim, bias=False)
        if with_sum:
            self.global_embedding = ConvNorm(dim, dim, kernel, groups=dim, bias=False)
        self.global_act = ConvNorm(dim, dim, kernel, groups=dim, bias=False)

    def forward(self, x_local: torch.Tensor, x_global: torch.Tensor) -> torch.Tensor:
        t = x_local.shape[-1]
        out = self.local_embedding(x_local) * nearest_resize(
            torch.sigmoid(self.global_act(x_global)), t)
        if self.with_sum:
            out = out + nearest_resize(self.global_embedding(x_global), t)
        return out


class TDAUConvBlock(nn.Module):
    """TDANet.py:326-422, on (B, C, T)."""

    def __init__(self, out_channels: int, in_channels: int, upsampling_depth: int,
                 torch_compat: bool = False):
        super().__init__()
        d, c = upsampling_depth, in_channels
        self.depth = d
        self.proj_1x1 = ConvNormAct(out_channels, c, 1)
        self.spp_dw = nn.ModuleList(
            DilatedConvNorm(c, c, 5, stride=1 if k == 0 else 2, groups=c) for k in range(d))
        self.loc_glo_fus = nn.ModuleList(Injection(c, 1) for _ in range(d))
        self.res_conv = nn.Conv1d(c, out_channels, 1)
        self.globalatt = GlobalAttention(c, torch_compat)
        self.last_layer = nn.ModuleList(Injection(c, 5, with_sum=True) for _ in range(d - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        levels = [self.spp_dw[0](self.proj_1x1(x))]
        for k in range(1, self.depth):
            levels.append(self.spp_dw[k](levels[-1]))
        bottom = levels[-1].shape[-1]
        global_f = sum(adaptive_avg_pool(f, bottom) for f in levels)
        global_f = self.globalatt(global_f)
        fused = [self.loc_glo_fus[i](levels[i], global_f) for i in range(self.depth)]
        expanded = None
        for i in range(self.depth - 2, -1, -1):
            other = fused[i - 1] if i == self.depth - 2 else expanded
            expanded = self.last_layer[i](fused[i], other)
        return self.res_conv(expanded) + x


class _Recurrent(nn.Module):
    def __init__(self, out_channels: int, in_channels: int, upsampling_depth: int,
                 num_blocks: int, torch_compat: bool):
        super().__init__()
        self.num_blocks = num_blocks
        self.unet = TDAUConvBlock(out_channels, in_channels, upsampling_depth, torch_compat)
        self.concat_block = nn.Sequential(
            nn.Conv1d(out_channels, out_channels, 1, groups=out_channels), PReLU())

    def forward(self, y0: torch.Tensor) -> torch.Tensor:
        y = self.unet(y0)
        for _ in range(1, self.num_blocks):
            y = self.unet(self.concat_block(y0 + y))
        return y


@register_model
class TDANet(BaseModel):
    """Keyword names are the JAX package's fields (tdanet.yaml);
    ``enc_kernel_size`` is in milliseconds. Built on ``device``: the card
    unless the caller names another."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512, num_blocks: int = 16,
                 upsampling_depth: int = 5, enc_kernel_size: int = 2, num_sources: int = 2,
                 sample_rate: int = 16000, torch_compat: bool = False, *, device=None):
        super().__init__(dict(out_channels=out_channels, in_channels=in_channels,
                              num_blocks=num_blocks, upsampling_depth=upsampling_depth,
                              enc_kernel_size=enc_kernel_size, num_sources=num_sources,
                              sample_rate=sample_rate, torch_compat=torch_compat))
        k = enc_kernel_size * sample_rate // 1000
        self.k, self.stride, basis = k, k // 4, k // 2 + 1
        self.num_sources, self.sample_rate = num_sources, sample_rate
        self.encoder = nn.Conv1d(1, basis, k, stride=k // 4, padding=k // 2, bias=False)
        self.ln = GlobLN(basis, eps=1e-5)
        self.bottleneck = nn.Conv1d(basis, out_channels, 1)
        self.sm = _Recurrent(out_channels, in_channels, upsampling_depth, num_blocks,
                             torch_compat)
        self.mask_net = nn.Sequential(PReLU(), nn.Conv1d(out_channels, num_sources * basis, 1))
        self.decoder = nn.ConvTranspose1d(num_sources * basis, num_sources, k, stride=k // 4,
                                          padding=k // 2, bias=False)
        self.place(device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # (B, T) → (B, S, T)
        if wav.dim() == 1:
            wav = wav[None, :]
        nsample, k, stride = wav.shape[-1], self.k, self.stride
        # pad_input (TDANet.py:497-510) and its trim (:539-545).
        rest = (k - (stride + nsample % k) % k) % k
        enc = self.encoder(F.pad(wav, (k - stride, k - stride + rest))[:, None, :])
        y = self.sm(self.bottleneck(self.ln(enc)))
        dec = masked_decode(self.mask_net, self.decoder, y, enc, self.num_sources)
        dec = dec[..., k - stride: dec.shape[-1] - (rest + k - stride)]
        return fit_length(dec, nsample)
