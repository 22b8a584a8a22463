"""DPRNN-TasNet (dual-path RNN separation) in PyTorch.

Port of ``sonicsim_tpu.models.dprnn`` (reference
separation/look2hear/models/dprnn.py:171-409; config
configs/separation/dprnn.yaml): ReLU conv encoder → GroupNorm(1) and a
1×1 bottleneck → 50%-overlap chunks → dual-path LSTM blocks → PReLU and a
per-speaker 1×1 mask conv → overlap-add → tanh·sigmoid gate → ReLU masks
on the encoder output → transposed-conv decoder, cut or zero-padded to the
input's length.

Parameter names are the reference's (``encoder.conv1d``,
``separation.{norm,conv1d,dual_rnn.{i},prelu,conv2d,output.0,
output_gate.0,end_conv1x1}``, ``decoder``). As in the JAX package,
``rnn_type`` and ``norm`` are kept as fields and the blocks are always
LSTMs with GroupNorm(1); ``dropout`` is kept and never applied.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import BaseModel, register_model
from .layers import PReLU
from .zoo_layers import DualRNNBlock, GroupNorm1, overlap_add_sequence, segment_sequence


class _Encoder(nn.Module):
    def __init__(self, n: int, k: int):
        super().__init__()
        self.conv1d = nn.Conv1d(1, n, k, stride=k // 2, bias=False)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # (B, T) → (B, N, T')
        return torch.relu(self.conv1d(wav[:, None, :]))


class _Separation(nn.Module):
    def __init__(self, n: int, c: int, hidden: int, bidirectional: bool, layers: int,
                 spks: int):
        super().__init__()
        self.norm = GroupNorm1(n)
        self.conv1d = nn.Conv1d(n, c, 1, bias=False)
        self.dual_rnn = nn.ModuleList(DualRNNBlock(c, hidden, bidirectional)
                                      for _ in range(layers))
        self.prelu = PReLU()
        self.conv2d = nn.Conv2d(c, c * spks, 1)
        self.output = nn.Sequential(nn.Conv1d(c, c, 1), nn.Tanh())
        self.output_gate = nn.Sequential(nn.Conv1d(c, c, 1), nn.Sigmoid())
        self.end_conv1x1 = nn.Conv1d(c, n, 1, bias=False)


@register_model
class DPRNNTasNet(BaseModel):
    """Keyword names are the JAX package's fields (dprnn.yaml). Built on
    ``device``: the card unless the caller names another."""

    def __init__(self, in_channels: int = 512, out_channels: int = 64,
                 hidden_channels: int = 128, kernel_size: int = 4, rnn_type: str = "LSTM",
                 norm: str = "gln", dropout: float = 0.0, bidirectional: bool = False,
                 num_layers: int = 4, K: int = 250, num_spks: int = 2,
                 sample_rate: int = 16000, *, device=None):
        super().__init__(dict(in_channels=in_channels, out_channels=out_channels,
                              hidden_channels=hidden_channels, kernel_size=kernel_size,
                              rnn_type=rnn_type, norm=norm, dropout=dropout,
                              bidirectional=bidirectional, num_layers=num_layers, K=K,
                              num_spks=num_spks, sample_rate=sample_rate))
        self.out_channels, self.K, self.num_spks = out_channels, K, num_spks
        self.sample_rate = sample_rate
        self.encoder = _Encoder(in_channels, kernel_size)
        self.separation = _Separation(in_channels, out_channels, hidden_channels,
                                      bidirectional, num_layers, num_spks)
        self.decoder = nn.ConvTranspose1d(in_channels, 1, kernel_size,
                                          stride=kernel_size // 2, bias=False)
        self.place(device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # (B, T) → (B, S, T)
        if wav.dim() == 1:
            wav = wav[None, :]
        nsample, sep, c = wav.shape[-1], self.separation, self.out_channels
        enc = self.encoder(wav)  # (B, N, T')
        w = sep.conv1d(sep.norm(enc)).transpose(1, 2)  # (B, T', C)
        chunks, gap = segment_sequence(w, self.K)  # (B, S, K, C)
        for block in sep.dual_rnn:
            chunks = block(chunks)
        m = sep.conv2d(sep.prelu(chunks).permute(0, 3, 1, 2))  # (B, C·spks, S, K)
        b, _, s, k = m.shape
        m = m.reshape(b * self.num_spks, c, s, k).permute(0, 2, 3, 1)
        masks = overlap_add_sequence(m, gap).transpose(1, 2)  # (B·spks, C, T')
        masks = torch.relu(sep.end_conv1x1(sep.output(masks) * sep.output_gate(masks)))
        masked = enc.repeat_interleave(self.num_spks, dim=0) * masks
        out = self.decoder(masked)[:, 0, :nsample]
        out = F.pad(out, (0, nsample - out.shape[-1]))
        return out.reshape(-1, self.num_spks, nsample)
