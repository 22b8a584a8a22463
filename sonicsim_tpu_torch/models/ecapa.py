"""ECAPA-TDNN speaker embedder in PyTorch (port of
``sonicsim_tpu.models.ecapa``).

The reference re-tracks separated speakers across VAD segments with
speechbrain's pretrained spkrec-ecapa-voxceleb model
(separation/inference.py:21-30,60-83): a TDNN stem, three SE-Res2Net
blocks at dilations 2/3/4, multi-layer feature aggregation, attentive
statistics pooling with global context and a 192-d embedding. The modules
run channel-first (B, C, T) under speechbrain's parameter names
(``blocks.0.conv.conv.weight``, ``…norm.norm.running_mean``), so an
``embedding_model.ckpt`` loads as it is. Inference only: the BatchNorms
use the checkpoint's running statistics.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..bridge import float32_tensors, resolve_device
from ..ops.stft import stft
from .zoo_layers import StatelessBatchNorm


def _same_pad(k: int, d: int) -> tuple[int, int]:
    span = d * (k - 1)
    return span // 2, span - span // 2


class _Conv(nn.Module):
    """speechbrain's Conv1d wrapper (``conv`` inside) with 'same' zero
    padding split as ``_same_pad``."""

    def __init__(self, nin: int, nout: int, k: int, dilation: int = 1):
        super().__init__()
        self.pad = _same_pad(k, dilation)
        self.conv = nn.Conv1d(nin, nout, k, dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, self.pad))


class _BatchNorm(nn.Module):
    """speechbrain's BatchNorm1d wrapper (``norm`` inside), eval-mode, on
    (B, C, T)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = StatelessBatchNorm(dim, use_running_stats=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x.transpose(1, 2)).transpose(1, 2)


class TDNNBlock(nn.Module):
    """Conv1d(k, dilation) → ReLU → BatchNorm (ECAPA_TDNN.py TDNNBlock)."""

    def __init__(self, nin: int, nout: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        self.conv = _Conv(nin, nout, kernel_size, dilation)
        self.norm = _BatchNorm(nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(torch.relu(self.conv(x)))


class Res2NetBlock(nn.Module):
    """Hierarchical multi-scale residual block (a ``scale``-way channel
    split)."""

    def __init__(self, channels: int, scale: int = 8, kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.scale = scale
        width = channels // scale
        self.blocks = nn.ModuleList(TDNNBlock(width, width, kernel_size, dilation)
                                    for _ in range(scale - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = x.chunk(self.scale, dim=1)
        outs, y = [chunks[0]], None
        for i, blk in enumerate(self.blocks, 1):
            y = blk(chunks[i] if i == 1 else chunks[i] + y)
            outs.append(y)
        return torch.cat(outs, dim=1)


class SEBlock(nn.Module):
    """Squeeze-and-excitation over time (ECAPA_TDNN.py SEBlock)."""

    def __init__(self, channels: int, se_channels: int = 128):
        super().__init__()
        self.conv1 = _Conv(channels, se_channels, 1)
        self.conv2 = _Conv(se_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=2, keepdim=True)
        return x * torch.sigmoid(self.conv2(torch.relu(self.conv1(s))))


class SERes2NetBlock(nn.Module):
    def __init__(self, channels: int, res2net_scale: int = 8, se_channels: int = 128,
                 kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.tdnn1 = TDNNBlock(channels, channels, 1)
        self.res2net_block = Res2NetBlock(channels, res2net_scale, kernel_size, dilation)
        self.tdnn2 = TDNNBlock(channels, channels, 1)
        self.se_block = SEBlock(channels, se_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.tdnn2(self.res2net_block(self.tdnn1(x)))
        return self.se_block(y) + x


class AttentiveStatsPool(nn.Module):
    """Attention-weighted mean and std with global context
    (AttentiveStatisticsPooling, global_context=True): (B, C, T) →
    (B, 2C)."""

    def __init__(self, channels: int, attention_channels: int = 128, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.tdnn = TDNNBlock(3 * channels, attention_channels, 1)
        self.conv = _Conv(attention_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=2, keepdim=True)
        std = torch.sqrt(torch.clamp(x.var(dim=2, keepdim=True, unbiased=False), min=self.eps))
        ctx = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=1)
        alpha = torch.softmax(self.conv(torch.tanh(self.tdnn(ctx))), dim=2)
        mu = (alpha * x).sum(dim=2)
        var = (alpha * x * x).sum(dim=2) - mu * mu
        return torch.cat([mu, torch.sqrt(torch.clamp(var, min=self.eps))], dim=1)


class EcapaTdnn(nn.Module):
    """The embedder: (B, T, n_feats) fbank frames → (B, lin_neurons), on
    ``device`` (the card unless given)."""

    def __init__(self, n_feats: int = 80, channels: int = 1024, res2net_scale: int = 8,
                 se_channels: int = 128, attention_channels: int = 128,
                 lin_neurons: int = 192, device=None):
        super().__init__()
        c = channels
        self.n_feats = n_feats
        with torch.device(resolve_device(device)):
            self.blocks = nn.ModuleList(
                [TDNNBlock(n_feats, c, 5)]
                + [SERes2NetBlock(c, res2net_scale, se_channels, 3, dil) for dil in (2, 3, 4)])
            self.mfa = TDNNBlock(3 * c, 3 * c, 1)
            self.asp = AttentiveStatsPool(3 * c, attention_channels)
            self.asp_bn = _BatchNorm(6 * c)
            self.fc = _Conv(6 * c, lin_neurons, 1)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = self.blocks[0](feats.transpose(1, 2))
        outs = []
        for blk in self.blocks[1:]:
            x = blk(x)
            outs.append(x)
        x = self.asp(self.mfa(torch.cat(outs, dim=1)))  # (B, 6C)
        return self.fc(self.asp_bn(x[:, :, None]))[:, :, 0]


# ---------------------------------------------------------------------------
# Feature front end: speechbrain's Fbank (n_fft 400, hop 160, 80 mels to
# 8 kHz, 10·log10 power with an 80 dB floor, sentence mean-norm).
# ---------------------------------------------------------------------------


def speechbrain_mel_fb(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                       f_max: float | None = None) -> np.ndarray:
    """speechbrain.processing.features.Filterbank's triangles: HTK mel
    points, each filter a SYMMETRIC triangle of half-width its LEFT mel gap
    (band[:-1]) → (n_mels, n_fft//2+1)."""
    f_max = f_max if f_max is not None else sample_rate / 2

    def to_mel(hz):
        return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)

    def to_hz(mel):
        return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)

    hz = to_hz(np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2))
    band = (hz[1:] - hz[:-1])[:-1]  # (n_mels,)
    f_central = hz[1:-1]  # (n_mels,)
    all_freqs = np.linspace(0, sample_rate // 2, n_fft // 2 + 1)
    slope = (all_freqs[None, :] - f_central[:, None]) / band[:, None]
    return np.maximum(0.0, np.minimum(slope + 1.0, 1.0 - slope)).astype(np.float32)


def ecapa_fbank(wav: torch.Tensor, sample_rate: int = 16000, n_mels: int = 80,
                n_fft: int = 400, hop: int = 160) -> torch.Tensor:
    """(T,) or (B, T) waveform → (B, frames, n_mels) normalised log-fbanks on
    the waveform's device: a periodic Hamming window, zero (constant)
    centre padding, the power spectrum, the symmetric mel triangles,
    10·log10 with a per-utterance floor 80 dB under its max, then the
    sentence mean subtracted (speechbrain's Fbank + InputNormalization
    'sentence', no std)."""
    wav = torch.atleast_2d(wav.to(torch.float32))
    pad = n_fft // 2
    x = F.pad(wav, (pad, pad))
    n = torch.arange(n_fft, device=wav.device, dtype=torch.float32)
    window = 0.54 - 0.46 * torch.cos(2.0 * torch.pi * n / n_fft)  # periodic
    spec = stft(x, n_fft, hop, window, center=False)  # (B, F, frames)
    power = spec.abs() ** 2
    fb = torch.from_numpy(speechbrain_mel_fb(sample_rate, n_fft, n_mels)).to(wav.device)
    mel = torch.einsum("mf,bft->btm", fb, power)
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)  # top_db
    return db - db.mean(dim=1, keepdim=True)


# ---------------------------------------------------------------------------
# speechbrain checkpoint import
# ---------------------------------------------------------------------------


def _scale(sd: dict) -> int:
    """Res2Net's scale: one more than its inner TDNN blocks."""
    marker = "blocks.1.res2net_block.blocks."
    return 2 + max(int(k[len(marker):].split(".")[0]) for k in sd if k.startswith(marker))


def ecapa_from_state_dict(sd: dict, device=None) -> EcapaTdnn:
    """speechbrain's embedding_model state dict → :class:`EcapaTdnn` on
    ``device`` (the card unless given), every dimension read off the
    weights. BatchNorm's ``num_batches_tracked`` is not read; a checkpoint
    without ``fc.conv.bias`` gets zeros there."""
    sd = float32_tensors({k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")})
    stem = sd["blocks.0.conv.conv.weight"]  # (C, n_feats, 5)
    lin = sd["fc.conv.weight"].shape[0]
    sd.setdefault("fc.conv.bias", torch.zeros(lin))
    model = EcapaTdnn(
        n_feats=stem.shape[1],
        channels=stem.shape[0],
        res2net_scale=_scale(sd),
        se_channels=sd["blocks.1.se_block.conv1.conv.weight"].shape[0],
        attention_channels=sd["asp.tdnn.conv.conv.weight"].shape[0],
        lin_neurons=lin,
        device="meta",
    )
    model.load_state_dict(sd, assign=True)
    return model.to(resolve_device(device)).eval()


def make_ecapa_embedder(checkpoint_path, device=None):
    """``embed(wav, sample_rate) -> (lin_neurons,)`` unit-norm numpy
    embedding for ``infer.stitch_segments(embed_fn=)``, from speechbrain's
    embedding_model.ckpt (a torch state dict), run on ``device`` (the card
    unless given)."""
    sd = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model = ecapa_from_state_dict(sd, device)
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def embed(wav, sample_rate=16000):
        wav = np.asarray(wav, np.float32)
        if sample_rate != 16000:
            # the weights expect 25 ms / 10 ms frames at 16 kHz, and n_fft
            # and hop are in samples: resample rather than rescale the bank
            from ..utils.wavio import resample

            wav = resample(wav, sample_rate, 16000)
        feats = ecapa_fbank(torch.from_numpy(np.ascontiguousarray(wav)).to(dev), 16000,
                            n_mels=model.n_feats)
        out = model(feats)[0].cpu().numpy()
        return out / (np.linalg.norm(out) + 1e-9)

    embed.model = model
    return embed
