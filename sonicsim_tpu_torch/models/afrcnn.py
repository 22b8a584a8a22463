"""AFRCNN (asynchronous fully-recurrent convolutional network) in PyTorch.

Port of ``sonicsim_tpu.models.afrcnn`` (reference
separation/look2hear/models/afrcnn.py:157-366; config
configs/separation/afrcnn.yaml): SuDORMRF's front and back end around one
multi-scale fusion block applied ``num_blocks`` times, with the bottleneck
features gated back in before each repeat (Recurrent, afrcnn.py:238-262).

Parameter names are the reference's: ``sm.blocks.{proj_1x1,spp_dw.{k},
fuse_layers.{i}.0,concat_layer.{i},last_layer.0,res_conv}`` (one shared
block) and ``sm.concat_block.{0,1}``, with SuDORMRF's ``encoder``, ``ln``,
``bottleneck``, ``mask_net`` and ``decoder``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import BaseModel, register_model
from .layers import Conv1d, ConvTranspose1d, PReLU
from .sudormrf import enc_lcm, fit_length, masked_decode, nearest_resize
from .zoo_layers import ConvNormAct, DilatedConvNorm, GlobLN


class FusionBlock(nn.Module):
    """Multi-scale downsampling and neighbour fusion (afrcnn.py:157-237), on
    (B, C, T). ``fuse_layers[i]`` holds level i's stride-2 conv of level
    i − 1 (none for level 0)."""

    def __init__(self, out_channels: int, in_channels: int, upsampling_depth: int):
        super().__init__()
        d, c = upsampling_depth, in_channels
        self.depth = d
        self.proj_1x1 = ConvNormAct(out_channels, c, 1)
        self.spp_dw = nn.ModuleList(
            DilatedConvNorm(c, c, 5, stride=1 if k == 0 else 2, groups=c) for k in range(d))
        self.fuse_layers = nn.ModuleList(
            nn.ModuleList([DilatedConvNorm(c, c, 5, stride=2, groups=c)] if i else [])
            for i in range(d))
        self.concat_layer = nn.ModuleList(
            ConvNormAct(c * (2 if i in (0, d - 1) else 3), c, 1) for i in range(d))
        self.last_layer = nn.Sequential(ConvNormAct(c * d, c, 1))
        self.res_conv = Conv1d(c, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        levels = [self.spp_dw[0](self.proj_1x1(x))]
        for k in range(1, self.depth):
            levels.append(self.spp_dw[k](levels[-1]))
        fused = []
        for i in range(self.depth):
            n = levels[i].shape[-1]
            parts = []
            if i >= 1:
                parts.append(self.fuse_layers[i][0](levels[i - 1])[..., :n])
            parts.append(levels[i])
            if i + 1 < self.depth:
                parts.append(nearest_resize(levels[i + 1], n))
            fused.append(self.concat_layer[i](torch.cat(parts, dim=1)))
        top = levels[0].shape[-1]
        fused = [fused[0]] + [nearest_resize(f, top) for f in fused[1:]]
        return self.res_conv(self.last_layer(torch.cat(fused, dim=1))) + x


class _Recurrent(nn.Module):
    def __init__(self, out_channels: int, in_channels: int, upsampling_depth: int,
                 num_blocks: int):
        super().__init__()
        self.num_blocks = num_blocks
        self.blocks = FusionBlock(out_channels, in_channels, upsampling_depth)
        self.concat_block = nn.Sequential(
            Conv1d(out_channels, out_channels, 1, groups=out_channels), PReLU())

    def forward(self, y0: torch.Tensor) -> torch.Tensor:
        y = self.blocks(y0)
        for _ in range(1, self.num_blocks):
            y = self.blocks(self.concat_block(y0 + y))
        return y


@register_model
class AFRCNN(BaseModel):
    """Keyword names are the JAX package's fields (afrcnn.yaml). Built on
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
        self.encoder = Conv1d(1, enc_num_basis, k, stride=k // 2, padding=k // 2, bias=False)
        self.ln = GlobLN(enc_num_basis, eps=1e-5)
        self.bottleneck = Conv1d(enc_num_basis, out_channels, 1)
        self.sm = _Recurrent(out_channels, in_channels, upsampling_depth, num_blocks)
        self.mask_net = nn.Sequential(PReLU(), Conv1d(out_channels,
                                                         num_sources * enc_num_basis, 1))
        self.decoder = ConvTranspose1d(num_sources * enc_num_basis, num_sources, k,
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
