"""G2Net (glance-and-gaze v2 enhancement) in PyTorch, and the gated TCM
TaylorSENet shares.

Port of ``sonicsim_tpu.models.g2net`` (reference
enhancement/look2hear/models/g2net.py:7-520; configs/enhancement/g2net.yaml:
RI + MAG U² heads, d_feat 256, two TCN lists per branch, dilations
[1, 2, 5, 9], 3 stages, crm1, causal, FFT 320 / hop 160): the compressed
STFT, separate U² encoders over the real/imaginary input and over the
magnitude, then stages of Glance (a magnitude gain from accumulated TCN
outputs) and Gaze (a complex residual) refinement. Output: the list of the
stage spectra, each (B, 2, F, T), as GaGNet's (``losses.gagnet``).

Names are the reference's. Its encoders' gated convs are two convs
(``conv``, ``gate_conv``), where the JAX package fuses them into one of
twice the channels (torch_import.py:536-544); ``bridge`` splits and joins
them. The blocks are ``models.gagnet``'s, and so is where the packages
part (zero-magnitude bins).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Conv1d, Conv2d, Linear
from .base import BaseModel, register_model
from .gagnet import (
    _ACTIVATIONS,
    ChannelPReLU,
    NormSwitch,
    U2Encoder,
    causal_pad1d,
    causal_pad2d,
    compressed_spectrum,
    flatten_channels,
    from_polar,
    polar,
)


class Gate2dConv(nn.Module):
    """G2Net's gated conv (g2net.py:601-630): ``conv`` = pad, conv and
    ``gate_conv`` = pad, conv, sigmoid; their product."""

    def __init__(self, cin: int, cout: int, kernel, stride=(1, 2)):
        super().__init__()
        kernel, stride = tuple(kernel), tuple(stride)
        self.conv = nn.Sequential(causal_pad2d(kernel[0]), Conv2d(cin, cout, kernel, stride))
        self.gate_conv = nn.Sequential(causal_pad2d(kernel[0]),
                                       Conv2d(cin, cout, kernel, stride), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) * self.gate_conv(x)


class GatedSqueezedTCM(nn.Module):
    """A squeezed TCM whose dilated conv is gated (g2net.py:356-402) on
    (B, d_feat, T): ``in_conv``; the two branches PReLU, norm, pad, conv
    (the second with a sigmoid), named by ``branches`` (G2Net's
    ``dd_conv_main``/``dd_conv_gate``, TaylorSENet's
    ``left_conv``/``right_conv``); ``out_conv`` = PReLU, norm, conv.
    ``norm`` builds the norms: G2Net's affine ``NormSwitch``, TaylorSENet's
    parameterless eps-1.0 instance norm."""

    def __init__(self, kd1: int, cd1: int, d_feat: int, dilation: int, is_causal: bool = True,
                 norm=NormSwitch, branches=("dd_conv_main", "dd_conv_gate")):
        super().__init__()
        self.branches = branches
        self.in_conv = Conv1d(d_feat, cd1, 1, bias=False)
        for name, tail in zip(branches, ([], [nn.Sigmoid()])):
            setattr(self, name, nn.Sequential(
                ChannelPReLU(cd1), norm(cd1), causal_pad1d(kd1, dilation, is_causal),
                Conv1d(cd1, cd1, kd1, dilation=dilation, bias=False), *tail))
        self.out_conv = nn.Sequential(ChannelPReLU(cd1), norm(cd1),
                                      Conv1d(cd1, d_feat, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(x)
        main, gate = (getattr(self, name) for name in self.branches)
        return x + self.out_conv(main(h) * gate(h))


class GatedTCNList(nn.Module):
    """``tcm_list``: one gated TCM per dilation (g2net.py:336-354)."""

    def __init__(self, kd1: int, cd1: int, d_feat: int, dilas, is_causal: bool = True,
                 **tcm):
        super().__init__()
        self.tcm_list = nn.ModuleList(GatedSqueezedTCM(kd1, cd1, d_feat, d, is_causal, **tcm)
                                      for d in dilas)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for tcm in self.tcm_list:
            x = tcm(x)
        return x


def _accumulate(tcns, x: torch.Tensor) -> torch.Tensor:
    """The sum of each TCN list's output, each fed the previous one's."""
    acc = torch.zeros_like(x)
    for tcn in tcns:
        x = tcn(x)
        acc = acc + x
    return acc


class GlanceBranch(nn.Module):
    """The magnitude gain (g2net.py:210-268): ``in_conv`` over the features
    and the magnitude, ``tcn_list``, ``linear_mag``."""

    def __init__(self, head_feat, d_feat, kd1, cd1, tcn_num, dilas, n_freq, is_causal,
                 acti_type):
        super().__init__()
        self.in_conv = Conv1d(head_feat + n_freq, d_feat, 1)
        self.tcn_list = nn.ModuleList(GatedTCNList(kd1, cd1, d_feat, dilas, is_causal)
                                      for _ in range(tcn_num))
        self.linear_mag = Conv1d(d_feat, n_freq, 1)
        self.act = _ACTIVATIONS[acti_type]()

    def forward(self, feat_x: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(torch.cat([feat_x, mag], dim=1))
        return self.act(self.linear_mag(_accumulate(self.tcn_list, h)))


class GazeBranch(nn.Module):
    """The complex residual (g2net.py:270-333): ``in_conv_r``/``in_conv_i``,
    ``tcn_r``/``tcn_i``, then ``linear_r``/``linear_i`` (``Linear`` over
    the channels) → (B, 2, F, T)."""

    def __init__(self, head_feat, d_feat, kd1, cd1, tcn_num, dilas, n_freq, is_causal):
        super().__init__()
        self.in_conv_r = Conv1d(head_feat + 2 * n_freq, d_feat, 1)
        self.in_conv_i = Conv1d(head_feat + 2 * n_freq, d_feat, 1)
        self.tcn_r = nn.ModuleList(GatedTCNList(kd1, cd1, d_feat, dilas, is_causal)
                                   for _ in range(tcn_num))
        self.tcn_i = nn.ModuleList(GatedTCNList(kd1, cd1, d_feat, dilas, is_causal)
                                   for _ in range(tcn_num))
        self.linear_r = Linear(d_feat, n_freq)
        self.linear_i = Linear(d_feat, n_freq)

    def forward(self, feat_x: torch.Tensor, com: torch.Tensor) -> torch.Tensor:
        z = torch.cat([feat_x, com], dim=1)
        ar = _accumulate(self.tcn_r, self.in_conv_r(z))
        ai = _accumulate(self.tcn_i, self.in_conv_i(z))
        return torch.stack([self.linear_r(ar.transpose(1, 2)).transpose(1, 2),
                            self.linear_i(ai.transpose(1, 2)).transpose(1, 2)], dim=1)


class G2GGModule(nn.Module):
    """One stage (g2net.py:152-208, crm1): ``glance_branch`` and
    ``gaze_branch`` on the features and the previous spectrum (B, 2, F, T)."""

    def __init__(self, head_feat, d_feat, kd1, cd1, tcn_num, dilas, n_freq, is_causal,
                 acti_type):
        super().__init__()
        self.glance_branch = GlanceBranch(head_feat, d_feat, kd1, cd1, tcn_num, dilas, n_freq,
                                          is_causal, acti_type)
        self.gaze_branch = GazeBranch(head_feat, d_feat, kd1, cd1, tcn_num, dilas, n_freq,
                                      is_causal)

    def forward(self, feat_x: torch.Tensor, pre_x: torch.Tensor) -> torch.Tensor:
        b, _, f, t = pre_x.shape
        mag, phase = polar(pre_x)
        gain = self.glance_branch(feat_x, mag)
        return from_polar(mag * gain, phase) + self.gaze_branch(feat_x, pre_x.reshape(b, 2 * f, t))


@register_model
class G2Net(BaseModel):
    """Keyword names are the JAX package's fields (g2net.yaml). As in the
    JAX model, ``crm_type`` is crm1 whatever it says and ``u_type`` and
    ``norm_type`` are not read. Built on ``device``: the card unless the
    caller names another."""

    def __init__(self, k1=(2, 3), k2=(1, 3), c: int = 64, intra_connect: str = "cat",
                 d_feat: int = 256, kd1: int = 3, cd1: int = 64, tcn_num: int = 2,
                 dilas=(1, 2, 5, 9), fft_num: int = 320, is_causal: bool = True,
                 acti_type: str = "sigmoid", crm_type: str = "crm1", stage_num: int = 3,
                 u_type: str = "u2", head_type: str = "RI+MAG", norm_type: str = "IN",
                 n_fft: int = 320, hop_length: int = 160, win_length: int = 320,
                 sample_rate: int = 16000, *, device=None):
        super().__init__(dict(k1=k1, k2=k2, c=c, intra_connect=intra_connect, d_feat=d_feat,
                              kd1=kd1, cd1=cd1, tcn_num=tcn_num, dilas=dilas, fft_num=fft_num,
                              is_causal=is_causal, acti_type=acti_type, crm_type=crm_type,
                              stage_num=stage_num, u_type=u_type, head_type=head_type,
                              norm_type=norm_type, n_fft=n_fft, hop_length=hop_length,
                              win_length=win_length, sample_rate=sample_rate))
        self.fft_num, self.hop_length = fft_num, hop_length
        self.n_fft, self.win_length = n_fft, win_length
        self.heads = [h for h in ("RI", "MAG") if h in head_type]
        n_freq = fft_num // 2 + 1
        k1, k2 = tuple(k1), tuple(k2)
        for head, cin in (("RI", 2), ("MAG", 1)):
            if head in self.heads:
                setattr(self, f"{head.lower()}_en",
                        U2Encoder(cin, c, k1, k2, intra_connect, gate=Gate2dConv))
        head_feat = d_feat * len(self.heads)
        self.ggms = nn.ModuleList(
            G2GGModule(head_feat, d_feat, kd1, cd1, tcn_num, tuple(dilas), n_freq, is_causal,
                       acti_type) for _ in range(stage_num))
        self.place(device)

    def forward(self, wav: torch.Tensor) -> list:
        if wav.dim() == 1:
            wav = wav[None, :]
        x_ri, mag, _ = compressed_spectrum(wav, self.fft_num, self.hop_length)
        inputs = {"RI": x_ri, "MAG": mag[:, None]}
        feat_x = torch.cat([flatten_channels(getattr(self, f"{h.lower()}_en")(inputs[h]))
                            for h in self.heads], dim=1)
        pre_x = x_ri.transpose(2, 3)  # (B, 2, F, T)
        outs = []
        for stage in self.ggms:
            pre_x = stage(feat_x, pre_x)
            outs.append(pre_x)
        return outs

