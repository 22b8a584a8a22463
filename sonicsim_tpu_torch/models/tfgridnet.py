"""TF-GridNet (full- and sub-band time-frequency modelling) in PyTorch.

Port of ``sonicsim_tpu.models.tfgridnet`` (reference
separation/look2hear/models/TFGNet.py:352-785; config
configs/separation/tfgridnet.yaml: n_fft 512, hop 128, 6 layers, emb 48,
kernel 4 / hop 1, BLSTM 192, 4 heads): the input divided by its standard
deviation → STFT (``ops.stft``) → 3×3 conv embedding → GridNetV2 blocks
(a BLSTM across frequency over unfolded patches, a BLSTM across frames, and
full-band self-attention over frames with per-head PReLU and norm) → 3×3
transposed conv to each source's complex spectrum → iSTFT, times the
deviation.

The blocks work on channel-last (B, T, F, C), as the JAX package's do; the
1×1 convs are ``F.linear`` on their ``Conv2d`` weights, under the
reference's names (``conv.{0,1}``, ``blocks.{i}.*``, ``deconv``). The
frame attention is an explicit product and softmax (TFGNet.py:699-711):
(heads, T, T) scores per item, scaled by 1/sqrt(E·F), softmax over the
keys, as the JAX model computes it.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.stft import hann_window, istft, stft
from .base import BaseModel, register_model
from .layers import PReLU
from .zoo_layers import LSTMLayer


def _conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1×1 ``Conv2d`` on channel-last x."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class AllHeadPReLULN(nn.Module):
    """AllHeadPReLULayerNormalization4DCF (TFGNet.py:739-768): (B, T, F,
    H·E) → (B, H, E, T, F), a PReLU slope per head, statistics over (E, F).
    ``gamma``/``beta`` (1, H, E, 1, F); ``act.weight`` (H,)."""

    def __init__(self, n_head: int, e_dim: int, n_freqs: int, eps: float = 1e-5):
        super().__init__()
        self.n_head, self.e_dim, self.eps = n_head, e_dim, eps
        self.gamma = nn.Parameter(torch.ones(1, n_head, e_dim, 1, n_freqs))
        self.beta = nn.Parameter(torch.zeros(1, n_head, e_dim, 1, n_freqs))
        self.act = nn.PReLU(num_parameters=n_head, init=0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, f, _ = x.shape
        y = x.reshape(b, t, f, self.n_head, self.e_dim).permute(0, 3, 4, 1, 2)
        y = torch.where(y >= 0, y, self.act.weight.view(1, -1, 1, 1, 1) * y)
        mu = y.mean(dim=(2, 4), keepdim=True)
        var = y.var(dim=(2, 4), keepdim=True, unbiased=False)
        return (y - mu) * torch.rsqrt(var + self.eps) * self.gamma + self.beta


class LayerNorm4DCF(nn.Module):
    """LayerNormalization4DCF (TFGNet.py:716-737): statistics over (F, C) of
    a channel-last (B, T, F, C); ``gamma``/``beta`` (1, C, 1, F) as the
    reference keeps them."""

    def __init__(self, dim: int, n_freqs: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(1, dim, 1, n_freqs))
        self.beta = nn.Parameter(torch.zeros(1, dim, 1, n_freqs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        return ((x - mu) * torch.rsqrt(var + self.eps) * self.gamma.permute(0, 2, 3, 1)
                + self.beta.permute(0, 2, 3, 1))


def _unfold_1d(x: torch.Tensor, ks: int, hs: int) -> torch.Tensor:
    """(N, L, C) → (N, n_win, C·ks) in ``F.unfold``'s channel-major order."""
    n, _, c = x.shape
    win = x.unfold(1, ks, hs)  # (N, n_win, C, ks)
    return win.reshape(n, win.shape[1], c * ks)


class GridNetV2Block(nn.Module):
    """TFGNet.py:539-713, on (B, T, Q, C)."""

    def __init__(self, emb_dim: int, emb_ks: int, emb_hs: int, n_freqs: int, hidden: int,
                 n_head: int = 4, approx_qk_dim: int = 512, eps: float = 1e-5):
        super().__init__()
        c, ks, hs = emb_dim, emb_ks, emb_hs
        self.ks, self.hs, self.n_head = ks, hs, n_head
        self.e_dim = math.ceil(approx_qk_dim / n_freqs)
        self.v_dim = emb_dim // n_head
        self.intra_norm = nn.LayerNorm(c, eps=eps)
        self.intra_rnn = LSTMLayer(c * ks, hidden, bidirectional=True)
        self.inter_norm = nn.LayerNorm(c, eps=eps)
        self.inter_rnn = LSTMLayer(c * ks, hidden, bidirectional=True)
        if ks == hs:
            self.intra_linear = nn.Linear(hidden * 2, c * ks)
            self.inter_linear = nn.Linear(hidden * 2, c * ks)
        else:
            self.intra_linear = nn.ConvTranspose1d(hidden * 2, c, ks, stride=hs)
            self.inter_linear = nn.ConvTranspose1d(hidden * 2, c, ks, stride=hs)
        for name, width in (("Q", self.e_dim), ("K", self.e_dim), ("V", self.v_dim)):
            setattr(self, f"attn_conv_{name}", nn.Conv2d(c, n_head * width, 1))
            setattr(self, f"attn_norm_{name}", AllHeadPReLULN(n_head, width, n_freqs, eps))
        self.attn_concat_proj = nn.Sequential(nn.Conv2d(c, c, 1), PReLU(),
                                              LayerNorm4DCF(c, n_freqs, eps))

    def _sub_band(self, norm, rnn, linear, x: torch.Tensor) -> torch.Tensor:
        """One BLSTM pass along axis 2 of (B, A, L, C), residual added."""
        b, a, length, c = x.shape
        h = _unfold_1d(norm(x).reshape(b * a, length, c), self.ks, self.hs)
        h = rnn(h)
        if self.ks == self.hs:
            h = linear(h).reshape(b, a, -1, self.ks, c)
        else:
            h = linear(h.transpose(1, 2)).transpose(1, 2)
        return x + h.reshape(b, a, length, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, old_t, old_q, c = x.shape
        ks, hs = self.ks, self.hs
        olp = ks - hs
        t_pad = math.ceil((old_t + 2 * olp - ks) / hs) * hs + ks
        q_pad = math.ceil((old_q + 2 * olp - ks) / hs) * hs + ks
        x = F.pad(x, (0, 0, olp, q_pad - old_q - olp, olp, t_pad - old_t - olp))
        x = self._sub_band(self.intra_norm, self.intra_rnn, self.intra_linear, x)
        x = self._sub_band(self.inter_norm, self.inter_rnn, self.inter_linear,
                           x.transpose(1, 2)).transpose(1, 2)
        x = x[:, olp:olp + old_t, olp:olp + old_q]

        # Full-band frame attention (TFGNet.py:699-711).
        h, e, v = self.n_head, self.e_dim, self.v_dim

        def heads(name):  # (B, H, T, width·F)
            y = getattr(self, f"attn_norm_{name}")(_conv1x1(getattr(self, f"attn_conv_{name}"), x))
            return y.transpose(2, 3).reshape(b, h, old_t, -1)

        q, k, vv = heads("Q"), heads("K"), heads("V")
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(e * old_q), dim=-1)
        out = (attn @ vv).reshape(b, h, old_t, v, old_q).permute(0, 2, 4, 1, 3)
        conv, prelu, norm = self.attn_concat_proj
        out = norm(prelu(_conv1x1(conv, out.reshape(b, old_t, old_q, h * v))))
        return out + x


@register_model
class TFGridNet(BaseModel):
    """Keyword names are the JAX package's fields (tfgridnet.yaml);
    ``input_dim``, ``window``, ``n_imics``, ``activation`` and
    ``use_builtin_complex`` are kept and unused, as there. Built on
    ``device``: the card unless the caller names another."""

    def __init__(self, input_dim: int = 64, n_srcs: int = 2, n_fft: int = 512,
                 stride: int = 128, window: str = "hann", n_imics: int = 1, n_layers: int = 6,
                 lstm_hidden_units: int = 192, attn_n_head: int = 4,
                 attn_approx_qk_dim: int = 512, emb_dim: int = 48, emb_ks: int = 4,
                 emb_hs: int = 1, activation: str = "prelu", eps: float = 1e-5,
                 use_builtin_complex: bool = False, sample_rate: int = 16000, *, device=None):
        super().__init__(dict(input_dim=input_dim, n_srcs=n_srcs, n_fft=n_fft, stride=stride,
                              window=window, n_imics=n_imics, n_layers=n_layers,
                              lstm_hidden_units=lstm_hidden_units, attn_n_head=attn_n_head,
                              attn_approx_qk_dim=attn_approx_qk_dim, emb_dim=emb_dim,
                              emb_ks=emb_ks, emb_hs=emb_hs, activation=activation, eps=eps,
                              use_builtin_complex=use_builtin_complex,
                              sample_rate=sample_rate))
        self.n_srcs, self.n_fft, self.stride = n_srcs, n_fft, stride
        self.sample_rate = sample_rate
        n_freqs = n_fft // 2 + 1
        self.conv = nn.Sequential(nn.Conv2d(2, emb_dim, 3, padding=1),
                                  nn.GroupNorm(1, emb_dim, eps=eps))
        self.blocks = nn.ModuleList(
            GridNetV2Block(emb_dim, emb_ks, emb_hs, n_freqs, lstm_hidden_units, attn_n_head,
                           attn_approx_qk_dim, eps) for _ in range(n_layers))
        self.deconv = nn.ConvTranspose2d(emb_dim, n_srcs * 2, 3, padding=1)
        self.place(device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # (B, T) → (B, S, T)
        if wav.dim() == 1:
            wav = wav[None, :]
        bsz, nsample = wav.shape
        window = hann_window(self.n_fft, device=wav.device)
        # Variance normalisation (TFGNet.py:495-497); torch.std is Bessel-corrected.
        std = wav.std(dim=1, keepdim=True) + 1e-8
        spec = stft(wav / std, self.n_fft, self.stride, window)  # (B, F, T)
        h = self.conv(torch.stack([spec.real, spec.imag], dim=1).transpose(2, 3))  # (B, C, T, F)
        h = h.permute(0, 2, 3, 1)
        for block in self.blocks:
            h = block(h)
        out = self.deconv(h.permute(0, 3, 1, 2))  # (B, 2·S, T, F)
        _, _, t, f = out.shape
        out = out.reshape(bsz, self.n_srcs, 2, t, f)
        est = torch.complex(out[:, :, 0], out[:, :, 1]).reshape(bsz * self.n_srcs, t, f)
        wav_out = istft(est.transpose(1, 2), self.n_fft, self.stride, window, length=nsample)
        return wav_out.reshape(bsz, self.n_srcs, nsample) * std[..., None]
