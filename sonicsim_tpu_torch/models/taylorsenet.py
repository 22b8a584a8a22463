"""TaylorSENet (Taylor-expansion speech enhancement) in PyTorch.

Port of ``sonicsim_tpu.models.taylorsenet`` (reference
enhancement/look2hear/models/taylorsenet.py:220-850;
configs/enhancement/taylorsenet.yaml: U² encoder/decoder, 64 channels,
d_feat 256, dilations [1, 2, 5, 9], p = 2, 3 orders, causal, IN): the
enhanced spectrum as a Taylor series, a zero-order magnitude gain from a
gated U²-UNet with a decoder, plus ``order_num`` complex high-order terms
(TCM stacks over fused features) accumulated as
``out += (H(feat, pre) + k·pre) / (k + 1)!``. Output: the compressed
spectrum (B, 2, T, F) for ``losses.taylorsenet``.

Every instance norm here is the reference's ``InstanceNorm2d(c, True)``:
``eps=1.0`` and no affine (taylorsenet.py:29-33 passes ``affine`` into the
``eps`` slot), as in the JAX package. Names are the reference's; the
blocks, and where the packages part, are ``models.gagnet``'s.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv1d, Conv2d, ConvTranspose2d
from .base import BaseModel, register_model
from .g2net import GatedTCNList
from .gagnet import (
    ChannelPReLU,
    ChompT,
    EnUnetModule,
    InstanceNorm,
    U2Encoder,
    compressed_spectrum,
    flatten_channels,
    from_polar,
)

NORM = partial(InstanceNorm, eps=1.0, affine=False)
TCM = dict(norm=NORM, branches=("left_conv", "right_conv"))


class GateConvTranspose2d(nn.Module):
    """Gated transposed conv with a trailing-time chomp when the time kernel
    is over 1 (taylorsenet.py:823-850): ``conv`` = deconv, [chomp]."""

    def __init__(self, cin: int, cout: int, kernel, stride=(1, 2)):
        super().__init__()
        kernel = tuple(kernel)
        conv = ConvTranspose2d(cin, 2 * cout, kernel, tuple(stride))
        self.conv = nn.Sequential(conv, ChompT(kernel[0] - 1)) if kernel[0] > 1 else conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, gate = self.conv(x).chunk(2, dim=1)
        return out * torch.sigmoid(gate)


def encoder(cin: int, c: int, k1, k2, intra_connect: str) -> U2Encoder:
    """TaylorSENet's U² encoder (taylorsenet.py:564-607): the first kernel
    (1, 5)."""
    return U2Encoder(cin, c, k1, k2, intra_connect, first_kernel=(1, 5), norm=NORM)


class U2NetDecoder(nn.Module):
    """The mirror decoder to the zero-order gain (taylorsenet.py:609-670,
    'cat'): ``meta_unet_list`` of four decoding UNet modules, each fed the
    previous output joined with an encoder skip, and ``last_conv`` = gated
    deconv, norm, PReLU, conv, sigmoid → (B, T, F')."""

    def __init__(self, c: int, k1, k2, intra_connect: str = "cat"):
        super().__init__()
        up = partial(EnUnetModule, gate=GateConvTranspose2d, norm=NORM)
        self.meta_unet_list = nn.ModuleList(
            up(64 * 2 if i == 0 else 2 * c, c, k1, k2, scale, intra_connect)
            for i, scale in enumerate((1, 2, 3, 4)))
        self.last_conv = nn.Sequential(GateConvTranspose2d(2 * c, 16, (1, 5)), NORM(16),
                                       ChannelPReLU(16), Conv2d(16, 1, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor, skips: list) -> torch.Tensor:
        # skips = [stage 0 … stage 3, bottom]: the first join pairs the
        # processed bottom with the raw one (taylorsenet.py:656-668).
        for i, unet in enumerate(self.meta_unet_list):
            skip = skips[-(i + 1)]
            x = unet(torch.cat([x[..., : skip.shape[-1]], skip], dim=1))
        x = torch.cat([x[..., : skips[0].shape[-1]], skips[0]], dim=1)
        return self.last_conv(x)[:, 0]


class ZeroOrderBlock(nn.Module):
    """``en`` over the magnitude, ``tcms`` over its flattened features, and
    ``de`` back to a gain."""

    def __init__(self, c, k1, k2, intra_connect, kd1, cd1, d_feat, dilations, p, is_causal):
        super().__init__()
        self.en = encoder(1, c, k1, k2, intra_connect)
        self.de = U2NetDecoder(c, k1, k2, intra_connect)
        self.tcms = nn.ModuleList(GatedTCNList(kd1, cd1, d_feat, dilations, is_causal, **TCM)
                                  for _ in range(p))

    def forward(self, mag: torch.Tensor) -> torch.Tensor:
        en_x, skips = self.en.stages(mag[:, None])  # (B, 64, T, F')
        b, c, t, f = en_x.shape
        feat = flatten_channels(en_x)
        for tcm in self.tcms:
            feat = tcm(feat)
        return self.de(feat.reshape(b, c, f, t).transpose(2, 3), skips)


class HighOrderBlock(nn.Module):
    """One high-order term (taylorsenet.py:470-520): ``in_conv`` over the
    features and the previous term (its (2, F) flatten real-major),
    ``tcms``, ``real_resi``/``imag_resi`` → (B, 2, T, F)."""

    def __init__(self, kd1, cd1, d_feat, dilations, p, n_freq, is_causal):
        super().__init__()
        self.in_conv = Conv1d(d_feat + 2 * n_freq, d_feat, 1)
        self.tcms = nn.ModuleList(GatedTCNList(kd1, cd1, d_feat, dilations, is_causal, **TCM)
                                  for _ in range(p))
        self.real_resi = Conv1d(d_feat, n_freq, 1)
        self.imag_resi = Conv1d(d_feat, n_freq, 1)

    def forward(self, feat: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
        b, _, t, f = pre.shape
        h = self.in_conv(torch.cat([feat, pre.transpose(2, 3).reshape(b, 2 * f, t)], dim=1))
        for tcm in self.tcms:
            h = tcm(h)
        return torch.stack([self.real_resi(h), self.imag_resi(h)], dim=1).transpose(2, 3)


@register_model
class TaylorSENet(BaseModel):
    """Keyword names are the JAX package's fields (taylorsenet.yaml). As in
    the JAX model, ``is_u2``, ``is_param_share``, ``is_encoder_share``,
    ``inter_connect`` and ``norm_type`` are not read. Built on ``device``:
    the card unless the caller names another."""

    def __init__(self, cin: int = 2, k1=(1, 3), k2=(2, 3), c: int = 64, kd1: int = 5,
                 cd1: int = 64, d_feat: int = 256, dilations=(1, 2, 5, 9), p: int = 2,
                 fft_num: int = 320, order_num: int = 3, n_fft: int = 320, hop_length: int = 160,
                 win_length: int = 320, intra_connect: str = "cat", inter_connect: str = "cat",
                 norm_type: str = "IN", is_causal: bool = True, is_u2: bool = True,
                 is_param_share: bool = False, is_encoder_share: bool = False,
                 sample_rate: int = 16000, *, device=None):
        super().__init__(dict(cin=cin, k1=k1, k2=k2, c=c, kd1=kd1, cd1=cd1, d_feat=d_feat,
                              dilations=dilations, p=p, fft_num=fft_num, order_num=order_num,
                              n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                              intra_connect=intra_connect, inter_connect=inter_connect,
                              norm_type=norm_type, is_causal=is_causal, is_u2=is_u2,
                              is_param_share=is_param_share, is_encoder_share=is_encoder_share,
                              sample_rate=sample_rate))
        self.fft_num, self.hop_length, self.d_feat = fft_num, hop_length, d_feat
        self.n_fft, self.win_length = n_fft, win_length
        n_freq = fft_num // 2 + 1
        k1, k2, dilations = tuple(k1), tuple(k2), tuple(dilations)
        self.zeroorderblock = ZeroOrderBlock(c, k1, k2, intra_connect, kd1, cd1, d_feat,
                                             dilations, p, is_causal)
        self.separate_en = encoder(cin, c, k1, k2, intra_connect)
        self.highorderblock_list = nn.ModuleList(
            HighOrderBlock(kd1, cd1, d_feat, dilations, p, n_freq, is_causal)
            for _ in range(order_num))
        self.place(device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if wav.dim() == 1:
            wav = wav[None, :]
        x_ri, mag, phase = compressed_spectrum(wav, self.fft_num, self.hop_length)
        n_freq = mag.shape[-1]
        gain = self.zeroorderblock(mag)[..., :n_freq]
        gain = F.pad(gain, (0, n_freq - gain.shape[-1]))
        zero = from_polar(gain * mag, phase)  # (B, 2, T, F)
        feat = flatten_channels(self.separate_en(x_ri))
        if feat.shape[1] != self.d_feat:
            raise ValueError(f"encoder feature dim {feat.shape[1]} != d_feat {self.d_feat}")
        out, pre = zero, zero
        for order, block in enumerate(self.highorderblock_list):
            pre = block(feat, pre) + order * pre
            out = out + pre / math.factorial(order + 1)
        return out
