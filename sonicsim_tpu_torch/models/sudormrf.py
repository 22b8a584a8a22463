"""SuDORMRF (successive down/up-sampling separation) in PyTorch.

Port of ``sonicsim_tpu.models.sudormrf`` (reference
separation/look2hear/models/sudormrf.py:159-330; config
configs/separation/sudormrf.yaml): conv encoder (kernel k, stride k/2,
pad k/2) → gLN and a 1×1 bottleneck → U-ConvBlocks (stride-2 depthwise
downsampling, nearest ×2 upsample-and-add) → PReLU and a mask conv → ReLU
masks on the encoder output → one transposed conv decoding every source.

Parameter names are the reference's (``encoder``, ``ln``, ``bottleneck``,
``sm.{i}.{proj_1x1,spp_dw.{k},final_norm,res_conv}``, ``mask_net.{0,1}``,
``decoder``). The decoder is torch's ``ConvTranspose1d`` with padding k/2
and output padding k/2 − 1, the crop the JAX package applies to its VALID
transpose.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import BaseModel, register_model
from .layers import PReLU
from .zoo_layers import ConvNormAct, DilatedConvNorm, GlobLN, NormAct


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2, mode='nearest')`` along the last axis."""
    return x.repeat_interleave(2, dim=-1)


def nearest_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest resize of the last axis to ``size``, frame ``i`` taking input
    ``floor(i·T/size)`` in integer arithmetic (sudormrf.py:28-32 of the JAX
    package); ``F.interpolate`` rounds a float scale and can pick another
    frame."""
    idx = torch.arange(size, device=x.device) * x.shape[-1] // size
    return x[..., idx]


def enc_lcm(enc_kernel_size: int, upsampling_depth: int) -> int:
    """The length the input is padded to a multiple of."""
    a, b = enc_kernel_size // 2, 2**upsampling_depth
    return abs(a * b) // math.gcd(a, b)


class UConvBlock(nn.Module):
    """sudormrf.py:159-217, on (B, C, T)."""

    def __init__(self, out_channels: int, in_channels: int, upsampling_depth: int):
        super().__init__()
        self.depth = upsampling_depth
        self.proj_1x1 = ConvNormAct(out_channels, in_channels, 1)
        self.spp_dw = nn.ModuleList(
            DilatedConvNorm(in_channels, in_channels, 5, stride=1 if k == 0 else 2,
                            groups=in_channels)
            for k in range(upsampling_depth))
        self.final_norm = NormAct(in_channels)
        self.res_conv = nn.Conv1d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        levels = [self.spp_dw[0](self.proj_1x1(x))]
        for k in range(1, self.depth):
            levels.append(self.spp_dw[k](levels[-1]))
        for _ in range(self.depth - 1):
            up = nearest_upsample_2x(levels.pop(-1))
            levels[-1] = levels[-1] + up[..., : levels[-1].shape[-1]]
        return self.res_conv(self.final_norm(levels[-1])) + x


def masked_decode(mask_net: nn.Sequential, decoder: nn.ConvTranspose1d, y: torch.Tensor,
                  enc: torch.Tensor, num_sources: int) -> torch.Tensor:
    """What SuDORMRF, AFRCNN and TDANet share after the separator: PReLU and
    a 1×1 conv to ``sources × basis`` masks, ReLU, times the encoder output,
    one transposed conv over every source's masked features. (B, C, T')
    separator output and (B, N, T') encoder output → (B, S, T'')."""
    m = mask_net(y)
    b, _, t = m.shape
    m = torch.relu(m.view(b, num_sources, -1, t))
    return decoder((m * enc[:, None]).reshape(b, -1, t))


def fit_length(x: torch.Tensor, nsample: int) -> torch.Tensor:
    """The last axis cut or zero-padded to ``nsample``."""
    x = x[..., :nsample]
    return F.pad(x, (0, nsample - x.shape[-1]))


@register_model
class SuDORMRF(BaseModel):
    """Keyword names are the JAX package's fields (sudormrf.yaml). Built on
    ``device``: the card unless the caller names another."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512, num_blocks: int = 16,
                 upsampling_depth: int = 4, enc_kernel_size: int = 21, enc_num_basis: int = 512,
                 num_sources: int = 2, sample_rate: int = 16000, *, device=None):
        super().__init__(dict(out_channels=out_channels, in_channels=in_channels,
                              num_blocks=num_blocks, upsampling_depth=upsampling_depth,
                              enc_kernel_size=enc_kernel_size, enc_num_basis=enc_num_basis,
                              num_sources=num_sources, sample_rate=sample_rate))
        k = enc_kernel_size
        self.num_sources, self.sample_rate = num_sources, sample_rate
        self.lcm = enc_lcm(k, upsampling_depth)
        self.encoder = nn.Conv1d(1, enc_num_basis, k, stride=k // 2, padding=k // 2, bias=False)
        self.ln = GlobLN(enc_num_basis, eps=1e-5)
        self.bottleneck = nn.Conv1d(enc_num_basis, out_channels, 1)
        self.sm = nn.Sequential(*(UConvBlock(out_channels, in_channels, upsampling_depth)
                                  for _ in range(num_blocks)))
        self.mask_net = nn.Sequential(PReLU(), nn.Conv1d(out_channels,
                                                         num_sources * enc_num_basis, 1))
        self.decoder = nn.ConvTranspose1d(num_sources * enc_num_basis, num_sources, k,
                                          stride=k // 2, padding=k // 2,
                                          output_padding=k // 2 - 1, bias=False)
        self.place(device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # (B, T) → (B, S, T)
        if wav.dim() == 1:
            wav = wav[None, :]
        nsample = wav.shape[-1]
        enc = self.encoder(F.pad(wav, (0, (-nsample) % self.lcm))[:, None, :])
        y = self.sm(self.bottleneck(self.ln(enc)))
        return fit_length(masked_decode(self.mask_net, self.decoder, y, enc, self.num_sources),
                          nsample)
