"""DPTNet (dual-path improved transformer) in PyTorch.

Port of ``sonicsim_tpu.models.dptnet`` (reference
separation/look2hear/models/dptnet.py:323-735; config
configs/separation/dptnet.yaml: conv encoder k4/s2 with 64 channels, 6
layers, unit 128, 4 heads, segment 360): ReLU conv encoder → gLN →
segments of ``segment_size`` frames at hop segment/2 with a segment of
zeros each side → intra- and inter-segment ImprovedTransformerLayers
(self-attention, residual and gLN, then an LSTM feed-forward) → PReLU and a
per-speaker 1×1 conv → overlap-add normalised by the overlap count →
tanh·sigmoid gate → masks on the encoder output → transposed-conv decoder.

Attention is ``nn.MultiheadAttention`` (the reference's ``self_attn``):
scale 1/sqrt(head width), softmax over the keys, as flax's
``MultiHeadDotProductAttention``; ``bridge`` carries flax's per-head
query/key/value/out denses to its ``in_proj``/``out_proj``. The
feed-forward's ReLU and dropout slots hold no parameters; the port keeps
the reference's index of its linear (``feed_forward.2``) and applies no
dropout, as the JAX model does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import BaseModel, register_model
from .layers import PReLU, get_activation
from .zoo_layers import F32_EPS, LSTMLayer


class DPGlobLN(nn.Module):
    """DPTNet's gLN (``gamma``/``beta`` of shape (1, C, 1)) over (T, C) of a
    channel-last (B, T, C), epsilon float32's, the JAX package's
    ``GroupNorm1``."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, dim, 1))
        self.beta = nn.Parameter(torch.zeros(1, dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        centred = x - x.mean(dim=(1, 2), keepdim=True)
        var = (centred * centred).mean(dim=(1, 2), keepdim=True)
        return centred * torch.rsqrt(var + F32_EPS) * self.gamma.view(-1) + self.beta.view(-1)


class ImprovedTransformerLayer(nn.Module):
    """dptnet.py:323-400, on (B, T, N)."""

    def __init__(self, input_size: int, att_heads: int, hidden_size: int,
                 bidirectional: bool = True, activation: str = "relu"):
        super().__init__()
        self.activation = get_activation(activation)
        self.self_attn = nn.MultiheadAttention(input_size, att_heads, batch_first=True)
        self.norm_attn = DPGlobLN(input_size)
        self.rnn = LSTMLayer(input_size, hidden_size, bidirectional)
        # The reference's Sequential(activation, Dropout, Linear): its linear.
        self.feed_forward = nn.ModuleDict(
            {"2": nn.Linear(hidden_size * (2 if bidirectional else 1), input_size)})
        self.norm_ff = DPGlobLN(input_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.norm_attn(self.self_attn(x, x, x, need_weights=False)[0] + x)
        h = self.feed_forward["2"](self.activation(self.rnn(out)))
        return self.norm_ff(h + out)


class _Encoder(nn.Module):
    def __init__(self, channel: int, kernel_size: int, stride: int):
        super().__init__()
        self.conv1d = nn.Conv1d(1, channel, kernel_size, stride=stride, bias=False)


class _Core(nn.Module):
    def __init__(self, channel, heads, unit, bidirectional, activation, layers, spks):
        super().__init__()
        self.row_transformer = nn.ModuleList(
            ImprovedTransformerLayer(channel, heads, unit, True, activation)
            for _ in range(layers))
        self.col_transformer = nn.ModuleList(
            ImprovedTransformerLayer(channel, heads, unit, bidirectional, activation)
            for _ in range(layers))
        self.output = nn.Sequential(PReLU(), nn.Conv2d(channel, channel * spks, 1))


class _Separator(nn.Module):
    def __init__(self, channel, heads, unit, bidirectional, activation, layers, spks):
        super().__init__()
        self.enc_LN = DPGlobLN(channel)
        self.dptnet = _Core(channel, heads, unit, bidirectional, activation, layers, spks)
        self.output = nn.Sequential(nn.Conv1d(channel, channel, 1), nn.Tanh())
        self.output_gate = nn.Sequential(nn.Conv1d(channel, channel, 1), nn.Sigmoid())


class _Decoder(nn.Module):
    def __init__(self, channel: int, kernel_size: int, stride: int):
        super().__init__()
        self.convtrans1d = nn.ConvTranspose1d(channel, 1, kernel_size, stride=stride,
                                              bias=False)


@register_model
class DPTNetModel(BaseModel):
    """Keyword names are the JAX package's fields (dptnet.yaml). Built on
    ``device``: the card unless the caller names another."""

    def __init__(self, channel: int = 64, kernel_size: int = 4, stride: int = 2,
                 num_spk: int = 2, layer: int = 6, bidirectional: bool = True, unit: int = 128,
                 att_heads: int = 4, activation: str = "relu", segment_size: int = 360,
                 nonlinear: str = "relu", sample_rate: int = 16000, *, device=None):
        super().__init__(dict(channel=channel, kernel_size=kernel_size, stride=stride,
                              num_spk=num_spk, layer=layer, bidirectional=bidirectional,
                              unit=unit, att_heads=att_heads, activation=activation,
                              segment_size=segment_size, nonlinear=nonlinear,
                              sample_rate=sample_rate))
        self.channel, self.num_spk, self.segment_size = channel, num_spk, segment_size
        self.nonlinear, self.sample_rate = get_activation(nonlinear), sample_rate
        self.encoder = _Encoder(channel, kernel_size, stride)
        self.separator = _Separator(channel, att_heads, unit, bidirectional, activation, layer,
                                    num_spk)
        self.decoder = _Decoder(channel, kernel_size, stride)
        self.place(device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # (B, T) → (B, S, T)
        if wav.dim() == 1:
            wav = wav[None, :]
        bsz, nsample = wav.shape
        sep, core, c = self.separator, self.separator.dptnet, self.channel
        feat = torch.relu(self.encoder.conv1d(wav[:, None, :]))  # (B, N, T)
        t_enc = feat.shape[-1]
        h = sep.enc_LN(feat.transpose(1, 2))  # (B, T, N)

        # split_feature (dptnet.py:663-671): a segment of zeros each side, hop seg/2.
        seg, hop = self.segment_size, self.segment_size // 2
        chunks = F.pad(h, (0, 0, seg, seg)).unfold(1, seg, hop).transpose(2, 3)  # (B, S, K, N)
        for row, col in zip(core.row_transformer, core.col_transformer):
            b, s, k, n = chunks.shape
            intra = row(chunks.reshape(b * s, k, n)).reshape(b, s, k, n)
            inter = col(intra.transpose(1, 2).reshape(b * k, s, n))
            chunks = inter.reshape(b, k, s, n).transpose(1, 2)

        out = core.output(chunks.permute(0, 3, 1, 2))  # (B, N·spk, S, K)
        b, _, s, k = out.shape
        cols = out.reshape(b * self.num_spk, c, s, k).transpose(2, 3).reshape(-1, c * k, s)
        # merge_feature (dptnet.py:673-701): overlap-add over the count.
        total = (s - 1) * hop + seg
        buf = F.fold(cols, (1, total), (1, seg), stride=(1, hop))[:, :, 0]
        norm = F.fold(torch.ones_like(cols[:1, :seg]), (1, total), (1, seg), stride=(1, hop))
        merged = (buf / torch.clamp(norm[:, :, 0], min=1e-8))[..., seg:seg + t_enc]
        masks = self.nonlinear(sep.output(merged) * sep.output_gate(merged))  # (B·spk, N, T)
        masked = feat.repeat_interleave(self.num_spk, dim=0) * masks
        out = self.decoder.convtrans1d(masked)[:, 0, :nsample]
        out = F.pad(out, (0, nsample - out.shape[-1]))
        return out.reshape(bsz, self.num_spk, nsample)
