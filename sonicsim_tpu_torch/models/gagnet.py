"""GaGNet (glance-and-gaze speech enhancement) in PyTorch, and the blocks
the GaGNet family (GaGNet, G2Net, TaylorSENet) shares.

Port of ``sonicsim_tpu.models.gagnet`` (reference
enhancement/look2hear/models/gagnet.py:6-640; configs/enhancement/gagnet.yaml:
U² encoder, 64 channels, d_feat 256, dilations [1, 2, 5, 9], p = 2, q = 3,
causal, instance norm, FFT 320 / hop 160): the RMS-normalised input, its
magnitude-compressed (√mag) STFT, a causal gated U²-encoder over (time,
frequency), then ``q`` Glance (real gain) + Gaze (complex residual) stages
refining the spectrum. Output: the list of the ``q`` stage spectra, each
(B, 2, F, T), which ``losses.gagnet`` scores and turns into a waveform.

Layout and names are the reference's: the 2-D blocks work on (B, C, T, F),
the TCMs on (B, C, T), and every parameter keeps the reference's name
(``en.meta_unet_list.0.in_conv.0.conv.1.weight``…; the JAX package's
converter, models/torch_import.py:503-608, reads the same names), so a
reference ``state_dict`` loads as it is. Parameterless layers (causal
pads, chomps, sigmoids) hold their ``nn.Sequential`` slots for that.

Where the two packages part: at an exactly zero-magnitude bin of a stage's
spectrum. ``torch.linalg.vector_norm`` and ``torch.atan2`` have the
gradient 0 there, JAX's ``linalg.norm`` and ``arctan2`` NaN. A trained
model's stage spectra have no such bins; the tests feed inputs that have
none. ``ChannelPReLU`` passes ``x ≥ 0`` as the JAX module's ``where``
does, so the two agree at 0 in value and gradient.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Conv1d, Conv2d, ConvTranspose2d
from ..ops.stft import hann_window, stft
from .base import BaseModel, register_model

_ACTIVATIONS = {"sigmoid": nn.Sigmoid, "tanh": nn.Tanh, "relu": nn.ReLU}


def _shape(x: torch.Tensor) -> tuple:
    """A per-channel vector's shape broadcast over (B, C, ...)."""
    return (-1,) + (1,) * (x.dim() - 2)


class ChannelPReLU(nn.Module):
    """PReLU with one slope per channel (axis 1), ``weight`` (C,) as in
    ``nn.PReLU(C)``; ``x ≥ 0`` passes."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((dim,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.reshape(_shape(x)) * x)


class InstanceNorm(nn.Module):
    """``nn.InstanceNorm1d/2d``: per-(B, C) statistics over the axes after
    the channels, the biased variance; with ``affine`` a per-channel
    ``weight``/``bias``. TaylorSENet's are ``eps=1.0, affine=False``: its
    NormSwitch passes ``affine`` into torch's ``eps`` slot
    (taylorsenet.py:29-33), and the JAX package keeps that."""

    def __init__(self, dim: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(2, x.dim()))
        mu = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, keepdim=True, unbiased=False)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        if self.weight is None:
            return y
        return y * self.weight.reshape(_shape(x)) + self.bias.reshape(_shape(x))


class NormSwitch(nn.Module):
    """GaGNet's and G2Net's norm wrapper: the affine instance norm under
    ``norm`` (``….norm.weight``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = InstanceNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class ChompT(nn.Module):
    """Drop the last ``t`` frames of (B, C, T, F): a causal transposed
    conv's trailing-time chomp."""

    def __init__(self, t: int):
        super().__init__()
        self.t = t

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, :, : x.shape[2] - self.t]


def causal_pad2d(kt: int) -> nn.Module:
    """Zeros before the first frame of (B, C, T, F) for a time kernel ``kt``."""
    return nn.ConstantPad2d((0, 0, kt - 1, 0), 0.0)


def _padded(conv: nn.Module, kt: int) -> nn.Module:
    """``conv`` after a causal time pad when ``kt > 1``, else ``conv`` alone
    (the reference's ``Sequential(pad, conv)``)."""
    return nn.Sequential(causal_pad2d(kt), conv) if kt > 1 else conv


class GateConv2d(nn.Module):
    """Causal gated conv (gagnet.py:545-571): one conv of ``2·cout`` channels,
    its first half times the sigmoid of its second; ``conv``."""

    def __init__(self, cin: int, cout: int, kernel, stride=(1, 2)):
        super().__init__()
        kernel = tuple(kernel)
        self.conv = _padded(Conv2d(cin, 2 * cout, kernel, tuple(stride)), kernel[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, gate = self.conv(x).chunk(2, dim=1)
        return out * torch.sigmoid(gate)


class Conv2dUnit(nn.Module):
    """Frequency-stride-2 conv with a causal time pad when the time kernel is
    over 1, + instance norm + PReLU (gagnet.py:501-517,
    taylorsenet.py:731-757): ``conv`` = [pad], conv, norm, PReLU."""

    def __init__(self, dim: int, kernel, norm=NormSwitch):
        super().__init__()
        kernel = tuple(kernel)
        pad = [causal_pad2d(kernel[0])] if kernel[0] > 1 else []
        self.conv = nn.Sequential(*pad, Conv2d(dim, dim, kernel, (1, 2)), norm(dim),
                                  ChannelPReLU(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Deconv2dUnit(nn.Module):
    """Frequency-stride-2 transposed conv with a trailing-time chomp when the
    time kernel is over 1, + instance norm + PReLU (gagnet.py:520-542,
    taylorsenet.py:760-793): ``deconv`` = deconv, [chomp], norm, PReLU."""

    def __init__(self, cin: int, dim: int, kernel, norm=NormSwitch):
        super().__init__()
        kernel = tuple(kernel)
        chomp = [ChompT(kernel[0] - 1)] if kernel[0] > 1 else []
        self.deconv = nn.Sequential(ConvTranspose2d(cin, dim, kernel, (1, 2)), *chomp,
                                    norm(dim), ChannelPReLU(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.deconv(x)


class EnUnetModule(nn.Module):
    """Gated in-conv + a small frequency UNet with a residual
    (gagnet.py:445-498, taylorsenet.py:672-729): ``in_conv`` = gate, norm,
    PReLU; ``enco`` and ``deco`` lists of ``scale`` units. ``gate`` builds
    the in-conv (``gate(cin, cout, kernel)``), ``norm`` the norms."""

    def __init__(self, cin: int, cout: int, k1, k2, scale: int, intra_connect: str = "cat",
                 gate=GateConv2d, norm=NormSwitch):
        super().__init__()
        self.intra_connect = intra_connect
        self.in_conv = nn.Sequential(gate(cin, cout, k1), norm(cout), ChannelPReLU(cout))
        self.enco = nn.ModuleList(Conv2dUnit(cout, k2, norm) for _ in range(scale))
        cat = cout if intra_connect == "add" else 2 * cout
        self.deco = nn.ModuleList(Deconv2dUnit(cout if i == 0 else cat, cout, k2, norm)
                                  for i in range(scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_resi = self.in_conv(x)
        h, skips = x_resi, []
        for unit in self.enco:
            h = unit(h)
            skips.append(h)
        for i, unit in enumerate(self.deco):
            if i > 0:
                skip = skips[-(i + 1)]
                h = h[..., : skip.shape[-1]]
                h = h + skip if self.intra_connect == "add" else torch.cat([h, skip], dim=1)
            h = unit(h)
        return x_resi + h[..., : x_resi.shape[-1]]


class U2Encoder(nn.Module):
    """The causal gated U²-encoder (gagnet.py:362-399): four UNet modules
    (``meta_unet_list``) and a gated conv to 64 channels (``last_conv``);
    (B, cin, T, F) → (B, 64, T, F'). ``stages`` also returns each module's
    output and the bottom (TaylorSENet's decoder skips)."""

    def __init__(self, cin: int, c: int = 64, k1=(2, 3), k2=(1, 3), intra_connect: str = "cat",
                 first_kernel=(2, 5), gate=GateConv2d, norm=NormSwitch):
        super().__init__()
        specs = [(cin, first_kernel, 4), (c, k1, 3), (c, k1, 2), (c, k1, 1)]
        self.meta_unet_list = nn.ModuleList(
            EnUnetModule(i, c, k, k2, scale, intra_connect, gate, norm) for i, k, scale in specs)
        self.last_conv = nn.Sequential(gate(c, 64, k1), norm(64), ChannelPReLU(64))

    def stages(self, x: torch.Tensor):
        skips = []
        for unet in self.meta_unet_list:
            x = unet(x)
            skips.append(x)
        x = self.last_conv(x)
        skips.append(x)
        return x, skips

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stages(x)[0]


def causal_pad1d(kd1: int, dilation: int, is_causal: bool) -> nn.Module:
    """The dilated conv's padding over T: all before (causal) or split."""
    pad = (kd1 - 1) * dilation
    return nn.ConstantPad1d((pad, 0) if is_causal else (pad // 2, pad - pad // 2), 0.0)


class SqueezedTCM(nn.Module):
    """Bottleneck dilated (causal) 1-D conv with a residual
    (gagnet.py:320-360) on (B, d_feat, T): ``in_conv``, ``d_conv`` = PReLU,
    norm, pad, conv; ``out_conv`` = PReLU, norm, conv."""

    def __init__(self, kd1: int, cd1: int, d_feat: int, dilation: int, is_causal: bool = True):
        super().__init__()
        self.in_conv = Conv1d(d_feat, cd1, 1, bias=False)
        self.d_conv = nn.Sequential(ChannelPReLU(cd1), NormSwitch(cd1),
                                    causal_pad1d(kd1, dilation, is_causal),
                                    Conv1d(cd1, cd1, kd1, dilation=dilation, bias=False))
        self.out_conv = nn.Sequential(ChannelPReLU(cd1), NormSwitch(cd1),
                                      Conv1d(cd1, d_feat, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.out_conv(self.d_conv(self.in_conv(x)))


class TCNGroup(nn.Module):
    """``tcns``: one SqueezedTCM per dilation."""

    def __init__(self, kd1: int, cd1: int, d_feat: int, dilas, is_causal: bool = True):
        super().__init__()
        self.tcns = nn.Sequential(*(SqueezedTCM(kd1, cd1, d_feat, d, is_causal) for d in dilas))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tcns(x)


def _tcn_groups(p: int, *args) -> nn.Sequential:
    return nn.Sequential(*(TCNGroup(*args) for _ in range(p)))


def _gated_in(ci: int, d_feat: int):
    """``in_conv_main`` and ``in_conv_gate`` (conv, sigmoid)."""
    return Conv1d(ci, d_feat, 1), nn.Sequential(Conv1d(ci, d_feat, 1), nn.Sigmoid())


class GlanceBlock(nn.Module):
    """The real-valued gain (gagnet.py:169-228): (B, ci, T) → (B, F, T)."""

    def __init__(self, kd1, cd1, d_feat, p, dilas, n_freq, ci, is_causal, acti_type):
        super().__init__()
        self.in_conv_main, self.in_conv_gate = _gated_in(ci, d_feat)
        self.tcn_g = _tcn_groups(p, kd1, cd1, d_feat, dilas, is_causal)
        self.linear_g = nn.Sequential(Conv1d(d_feat, n_freq, 1), _ACTIVATIONS[acti_type]())

    def forward(self, inpt: torch.Tensor) -> torch.Tensor:
        return self.linear_g(self.tcn_g(self.in_conv_main(inpt) * self.in_conv_gate(inpt)))


class GazeBlock(nn.Module):
    """The complex residual (gagnet.py:231-292): (B, ci, T) → (B, 2, F, T)."""

    def __init__(self, kd1, cd1, d_feat, p, dilas, n_freq, ci, is_causal):
        super().__init__()
        self.in_conv_main, self.in_conv_gate = _gated_in(ci, d_feat)
        self.tcm_r = _tcn_groups(p, kd1, cd1, d_feat, dilas, is_causal)
        self.tcm_i = _tcn_groups(p, kd1, cd1, d_feat, dilas, is_causal)
        self.linear_r = Conv1d(d_feat, n_freq, 1)
        self.linear_i = Conv1d(d_feat, n_freq, 1)

    def forward(self, inpt: torch.Tensor) -> torch.Tensor:
        z = self.in_conv_main(inpt) * self.in_conv_gate(inpt)
        return torch.stack([self.linear_r(self.tcm_r(z)), self.linear_i(self.tcm_i(z))], dim=1)


def polar(spec: torch.Tensor):
    """(B, 2, ...) real/imaginary → magnitude and phase, each (B, ...)."""
    return torch.linalg.vector_norm(spec, dim=1), torch.atan2(spec[:, 1], spec[:, 0])


def from_polar(mag: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    return torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)], dim=1)


class GlanceGazeModule(nn.Module):
    """One stage (gagnet.py:125-166): ``glance_block`` and ``gaze_block`` on
    the features and the previous stage's spectrum (B, 2, F, T), whose
    (2, F) flatten is real-major."""

    def __init__(self, kd1, cd1, d_feat, p, dilas, n_freq, is_causal, acti_type):
        super().__init__()
        ci = d_feat + 2 * n_freq
        self.glance_block = GlanceBlock(kd1, cd1, d_feat, p, dilas, n_freq, ci, is_causal,
                                        acti_type)
        self.gaze_block = GazeBlock(kd1, cd1, d_feat, p, dilas, n_freq, ci, is_causal)

    def forward(self, feat_x: torch.Tensor, pre_x: torch.Tensor) -> torch.Tensor:
        b, _, f, t = pre_x.shape
        inpt = torch.cat([feat_x, pre_x.reshape(b, 2 * f, t)], dim=1)
        gain = self.glance_block(inpt)
        mag, phase = polar(pre_x)
        return from_polar(mag * gain, phase) + self.gaze_block(inpt)


def unet_encoder(cin: int, c: int, k1) -> nn.Sequential:
    """GaGNet's plain encoder (``is_u2=False``, the JAX model's
    gagnet.py:316-323): five gated convs of frequency stride 2, kernels
    (2, 5) then ``k1`` four times, each with an instance norm and a PReLU;
    ``c`` channels, 64 in the last. ``{i}.{0,1,2}`` hold the JAX model's
    ``unet_{i}_{gate,norm,prelu}``."""
    blocks, n_in = [], cin
    for i, k in enumerate([(2, 5)] + [tuple(k1)] * 4):
        n_out = 64 if i == 4 else c
        blocks.append(nn.Sequential(GateConv2d(n_in, n_out, k), NormSwitch(n_out),
                                    ChannelPReLU(n_out)))
        n_in = n_out
    return nn.Sequential(*blocks)


def compressed_spectrum(wav: torch.Tensor, fft_num: int, hop_length: int):
    """RMS-normalised ``wav`` (B, L) → its √mag-compressed STFT (B, 2, T, F),
    the compressed magnitude (B, T, F) and the phase (B, T, F)
    (gagnet.py:88-99)."""
    wav = wav * torch.sqrt(wav.shape[-1] / torch.sum(wav**2, dim=-1, keepdim=True))
    spec = stft(wav, fft_num, hop_length, hann_window(fft_num, device=wav.device))
    spec = spec.transpose(1, 2)  # (B, T, F)
    mag = torch.sqrt(spec.abs())
    phase = torch.atan2(spec.imag, spec.real)
    return from_polar(mag, phase), mag, phase


def flatten_channels(h: torch.Tensor) -> torch.Tensor:
    """(B, C, T, F) → (B, C·F, T), channel-major (gagnet.py:112-113)."""
    b, c, t, f = h.shape
    return h.transpose(2, 3).reshape(b, c * f, t)


@register_model
class GaGNet(BaseModel):
    """Keyword names are the JAX package's fields (gagnet.yaml). The JAX
    model takes ``is_squeezed`` and ``norm_type`` without reading them;
    so does this one. ``is_u2=False`` (taken by no config) swaps the U²
    encoder for :func:`unet_encoder`. Built on ``device``: the card unless
    the caller names another."""

    def __init__(self, cin: int = 2, k1=(2, 3), k2=(1, 3), c: int = 64, kd1: int = 3,
                 cd1: int = 64, d_feat: int = 256, p: int = 2, q: int = 3,
                 dilas=(1, 2, 5, 9), fft_num: int = 320, is_u2: bool = True,
                 is_causal: bool = True, is_squeezed: bool = False, acti_type: str = "sigmoid",
                 intra_connect: str = "cat", norm_type: str = "IN", n_fft: int = 320,
                 hop_length: int = 160, win_length: int = 320, sample_rate: int = 16000, *,
                 device=None):
        super().__init__(dict(cin=cin, k1=k1, k2=k2, c=c, kd1=kd1, cd1=cd1, d_feat=d_feat, p=p,
                              q=q, dilas=dilas, fft_num=fft_num, is_u2=is_u2,
                              is_causal=is_causal, is_squeezed=is_squeezed,
                              acti_type=acti_type, intra_connect=intra_connect,
                              norm_type=norm_type, n_fft=n_fft, hop_length=hop_length,
                              win_length=win_length, sample_rate=sample_rate))
        self.fft_num, self.hop_length, self.d_feat = fft_num, hop_length, d_feat
        self.n_fft, self.win_length = n_fft, win_length
        n_freq = fft_num // 2 + 1
        self.en = (U2Encoder(cin, c, tuple(k1), tuple(k2), intra_connect) if is_u2
                   else unet_encoder(cin, c, tuple(k1)))
        self.gags = nn.ModuleList(
            GlanceGazeModule(kd1, cd1, d_feat, p, tuple(dilas), n_freq, is_causal, acti_type)
            for _ in range(q))
        self.place(device)

    def forward(self, wav: torch.Tensor) -> list:
        if wav.dim() == 1:
            wav = wav[None, :]
        x, _, _ = compressed_spectrum(wav, self.fft_num, self.hop_length)
        feat_x = flatten_channels(self.en(x))
        if feat_x.shape[1] != self.d_feat:
            raise ValueError(f"encoder feature dim {feat_x.shape[1]} != d_feat {self.d_feat}")
        pre_x = x.transpose(2, 3)  # (B, 2, F, T)
        outs = []
        for stage in self.gags:
            pre_x = stage(feat_x, pre_x)
            outs.append(pre_x)
        return outs

