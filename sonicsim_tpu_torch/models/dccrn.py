"""DCCRN (deep complex convolution recurrent network) in PyTorch, and the
conv-STFT pair DCCRN and FRCRN share.

Port of ``sonicsim_tpu.models.dccrn`` (reference
enhancement/look2hear/models/dccrn.py:11-226, complexnn.py and
conv_stft.py; config configs/enhancement/dccrn.yaml: rnn 256, masking E,
complex LSTM, kernels [32, 64, 128, 256, 256, 256]): a complex conv
encoder over (frequency, time) with causal time padding, a complex LSTM
bottleneck, a skip-connected complex transposed-conv decoder, polar (E)
masking and conv-STFT framing (window 400, hop 100, FFT 512, padded
window − hop on both sides).

Parameter names are the reference's (``encoder.{i}.{0.{real,imag}_conv,1,2}``,
``enhance.{l}.{real,imag}_lstm``, ``enhance.{l}.{r,i}_trans``,
``decoder.{i}.{0.{real,imag}_conv,1,2}``); each layout is (B, C, F, T).
The BatchNorms (``*.1``) run on batch statistics, as the JAX model does
unless ``torch_compat`` (the reference checkpoints' frozen running
statistics) is set. ``use_clstm=False`` (taken by no config) runs a
two-layer real LSTM over the real and imaginary features joined
(``enhance``) and a Dense back to both (``tranform``), as the JAX model's
``OptimizedLSTMCell_{0,1}`` and ``tranform``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.stft import _overlap_add
from .base import BaseModel, register_model
from .layers import Conv2d, ConvTranspose2d, Linear, PReLU, float32_or_wider, promote
from .zoo_layers import LSTMLayer, StatelessBatchNorm


@functools.lru_cache(maxsize=None)
def _hann(win_len: int) -> np.ndarray:
    """scipy's periodic Hann (``get_window("hann", fftbins=True)``), float32."""
    from scipy.signal import get_window

    return get_window("hann", win_len, fftbins=True).astype(np.float32)


def _window(win_len: int, sqrt_window: bool, device) -> torch.Tensor:
    w = _hann(win_len) ** 0.5 if sqrt_window else _hann(win_len)
    return torch.from_numpy(w).to(device)


@functools.lru_cache(maxsize=None)
def _istft_pinv(win_len: int, fft_len: int) -> np.ndarray:
    """The least-squares synthesis matrix (2F, win): the reference inverts
    the un-windowed real-DFT analysis matrix with pinv (conv_stft.py:20-22),
    in float64, cast to float32."""
    basis = np.fft.rfft(np.eye(fft_len))[:win_len]
    analysis = np.concatenate([basis.real, basis.imag], 1).T  # (2F, win)
    return np.linalg.pinv(analysis).astype(np.float32).T  # (2F, win)


@functools.lru_cache(maxsize=None)
def _pinv_on(win_len: int, fft_len: int, device: torch.device) -> torch.Tensor:
    """The synthesis matrix on ``device``, kept for every later call: made
    outside inference mode, so a cache first filled while serving can
    still be saved for a training step's backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(_istft_pinv(win_len, fft_len)).to(device)


def conv_stft(x: torch.Tensor, win_len: int, hop: int, fft_len: int,
              sqrt_window: bool = False, pad_signal: bool = True):
    """ConvSTFT's 'complex' output: (B, T) → (real, imag), each
    (B, F, frames). DCCRN (conv_stft.py:46-50) pads window − hop on both
    sides under a Hann window; FRCRN (frcrn.py:56-84) pads nothing, under a
    sqrt-Hann window."""
    pad = win_len - hop if pad_signal else 0
    xp = F.pad(x, (pad, pad)) if pad else x
    window = _window(win_len, sqrt_window, x.device).to(float32_or_wider(x.dtype))
    frames = xp.unfold(-1, win_len, hop) * window
    spec = torch.fft.rfft(frames, n=fft_len)  # (B, frames, F)
    return spec.real.transpose(1, 2), spec.imag.transpose(1, 2)


def conv_istft(real: torch.Tensor, imag: torch.Tensor, win_len: int, hop: int, fft_len: int,
               length: int, sqrt_window: bool = False, crop_pad: bool = True) -> torch.Tensor:
    """ConviSTFT: the pinv synthesis, an overlap-add normalised by the summed
    squared window, then (DCCRN, ``crop_pad``) the analysis padding cut;
    sliced or zero-padded to ``length``. The overlap-add is ``F.fold``, which
    sums each output sample in a fixed order, so repeated runs on the card
    are bit-equal."""
    table = float32_or_wider(real.dtype)
    window = _window(win_len, sqrt_window, real.device).to(table)
    spec_ri = torch.cat([real, imag], dim=1)  # (B, 2F, frames)
    pinv = _pinv_on(win_len, fft_len, real.device).to(table)
    frames = torch.einsum("bft,fw->btw", *promote(spec_ri, pinv))
    frames = frames * window
    n_frames = frames.shape[1]
    out = _overlap_add(frames, hop)
    wsum = _overlap_add((window * window).expand(1, n_frames, win_len), hop)[0]
    out = out / (wsum + 1e-8)
    pad = win_len - hop if crop_pad else 0
    out = out[:, pad:pad + length]
    return F.pad(out, (0, length - out.shape[-1]))


class HalvesBatchNorm(StatelessBatchNorm):
    """The reference's BatchNorm2d over the complex halves stacked on the
    channels, [real; imag] (2C), on a (real, imag) pair of (B, C, F, T)."""

    def forward(self, real: torch.Tensor, imag: torch.Tensor):  # type: ignore[override]
        y = super().forward(torch.cat([real, imag], dim=1).movedim(1, -1)).movedim(-1, 1)
        return y.chunk(2, dim=1)


class ComplexConv2d(nn.Module):
    """Kernel (kf, kt), stride (2, 1), frequency padded on both sides, time
    on the left (complexnn.py:344-413): ``real_conv``, ``imag_conv``."""

    def __init__(self, cin: int, cout: int, kernel=(5, 2), freq_pad: int = 2,
                 causal_time_pad: int = 1):
        super().__init__()
        self.pads = (causal_time_pad, 0, freq_pad, freq_pad)
        self.real_conv = Conv2d(cin, cout, kernel, stride=(2, 1))
        self.imag_conv = Conv2d(cin, cout, kernel, stride=(2, 1))

    def forward(self, real: torch.Tensor, imag: torch.Tensor):
        pr, pi = F.pad(real, self.pads), F.pad(imag, self.pads)
        return (self.real_conv(pr) - self.imag_conv(pi),
                self.real_conv(pi) + self.imag_conv(pr))


class ComplexConvTranspose2d(nn.Module):
    """Stride-(2, 1) complex transposed conv, cropped to twice the input's
    frequencies as torch's padding (2, 0) and output padding (1, 0) do
    (complexnn.py:415-470): ``real_conv``, ``imag_conv``."""

    def __init__(self, cin: int, cout: int, kernel=(5, 2)):
        super().__init__()
        self.real_conv = ConvTranspose2d(cin, cout, kernel, stride=(2, 1))
        self.imag_conv = ConvTranspose2d(cin, cout, kernel, stride=(2, 1))

    def forward(self, real: torch.Tensor, imag: torch.Tensor):
        f_in = real.shape[2]
        rr = self.real_conv(real) - self.imag_conv(imag)
        ii = self.real_conv(imag) + self.imag_conv(real)
        return rr[:, :, 2:2 + 2 * f_in], ii[:, :, 2:2 + 2 * f_in]


class ComplexLSTM(nn.Module):
    """NavieComplexLSTM (complexnn.py:292-330), batch-first: ``real_lstm``,
    ``imag_lstm`` and, with a projection, ``r_trans``, ``i_trans``."""

    def __init__(self, input_size: int, hidden: int, projection_dim: int | None = None):
        super().__init__()
        self.real_lstm = LSTMLayer(input_size, hidden)
        self.imag_lstm = LSTMLayer(input_size, hidden)
        if projection_dim is not None:
            self.r_trans = Linear(hidden, projection_dim)
            self.i_trans = Linear(hidden, projection_dim)

    def forward(self, real: torch.Tensor, imag: torch.Tensor):
        out_r = self.real_lstm(real) - self.imag_lstm(imag)
        out_i = self.real_lstm(imag) + self.imag_lstm(real)
        if hasattr(self, "r_trans"):
            out_r, out_i = self.r_trans(out_r), self.i_trans(out_i)
        return out_r, out_i


@register_model
class DCCRN(BaseModel):
    """Keyword names are the JAX package's fields (dccrn.yaml). Built on
    ``device``: the card unless the caller names another."""

    def __init__(self, rnn_layers: int = 2, rnn_units: int = 256, win_len: int = 400,
                 win_inc: int = 100, fft_len: int = 512, win_type: str = "hann",
                 masking_mode: str = "E", use_clstm: bool = True, use_cbn: bool = False,
                 kernel_size: int = 5, kernel_num=(32, 64, 128, 256, 256, 256),
                 sample_rate: int = 16000, torch_compat: bool = False, *, device=None):
        super().__init__(dict(rnn_layers=rnn_layers, rnn_units=rnn_units, win_len=win_len,
                              win_inc=win_inc, fft_len=fft_len, win_type=win_type,
                              masking_mode=masking_mode, use_clstm=use_clstm, use_cbn=use_cbn,
                              kernel_size=kernel_size, kernel_num=tuple(kernel_num),
                              sample_rate=sample_rate, torch_compat=torch_compat))
        self.win_len, self.win_inc, self.fft_len = win_len, win_inc, fft_len
        self.masking_mode = masking_mode
        halves = [k // 2 for k in (2,) + tuple(kernel_num)]
        n = len(halves) - 1
        self.encoder = nn.ModuleList(
            nn.ModuleList([ComplexConv2d(halves[i], halves[i + 1]),
                           HalvesBatchNorm(2 * halves[i + 1], use_running_stats=torch_compat),
                           PReLU()])
            for i in range(n))
        f_b = fft_len // 2
        for _ in range(n):
            f_b = (f_b - 1) // 2 + 1
        width = f_b * halves[-1]
        self.use_clstm = use_clstm
        if use_clstm:
            self.enhance = nn.ModuleList(
                ComplexLSTM(width if li == 0 else rnn_units // 2, rnn_units // 2,
                            width if li == rnn_layers - 1 else None)
                for li in range(rnn_layers))
        else:
            # The real LSTM over [real; imag] features (dccrn.py:231-236): two
            # layers of ``rnn_units`` whatever ``rnn_layers`` says, as in the
            # JAX model, then the Dense the reference spells ``tranform``.
            self.enhance = LSTMLayer(2 * width, rnn_units, num_layers=2)
            self.tranform = Linear(rnn_units, 2 * width)
        self.decoder = nn.ModuleList()
        for i in range(n):
            cin, cout = 2 * halves[-1 - i], halves[-2 - i] if i < n - 1 else 1
            layer = [ComplexConvTranspose2d(cin, cout)]
            if i < n - 1:
                layer += [HalvesBatchNorm(2 * cout, use_running_stats=torch_compat), PReLU()]
            self.decoder.append(nn.ModuleList(layer))
        self.place(device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # (B, T) → (B, T)
        if wav.dim() == 1:
            wav = wav[None, :]
        length = wav.shape[-1]
        real_s, imag_s = conv_stft(wav, self.win_len, self.win_inc, self.fft_len)
        mags = torch.sqrt(real_s**2 + imag_s**2 + 1e-8)
        phase = torch.atan2(imag_s, real_s)

        # The DC bin dropped; (B, C=1, F, T) each part (dccrn.py:155-157).
        real, imag = real_s[:, None, 1:], imag_s[:, None, 1:]
        skips = []
        for conv, bn, act in self.encoder:
            real, imag = bn(*conv(real, imag))
            real, imag = act(real), act(imag)
            skips.append((real, imag))

        # torch flattens (C, F) channel-major (dccrn.py:171-175).
        b, c_b, f_b, t_b = real.shape
        r_in = real.permute(0, 3, 1, 2).reshape(b, t_b, c_b * f_b)
        i_in = imag.permute(0, 3, 1, 2).reshape(b, t_b, c_b * f_b)
        if self.use_clstm:
            for clstm in self.enhance:
                r_in, i_in = clstm(r_in, i_in)
        else:
            r_in, i_in = self.tranform(self.enhance(torch.cat([r_in, i_in], -1))).chunk(2, -1)
        real = r_in.reshape(b, t_b, c_b, f_b).permute(0, 2, 3, 1)
        imag = i_in.reshape(b, t_b, c_b, f_b).permute(0, 2, 3, 1)

        for layer, (skip_r, skip_i) in zip(self.decoder, reversed(skips)):
            real, imag = layer[0](torch.cat([real, skip_r], dim=1),
                                  torch.cat([imag, skip_i], dim=1))
            real, imag = real[..., 1:], imag[..., 1:]  # causal trim (dccrn.py:193)
            if len(layer) > 1:
                real, imag = layer[1](real, imag)
                real, imag = layer[2](real), layer[2](imag)

        mask_real = F.pad(real[:, 0], (0, 0, 1, 0))  # the DC bin back
        mask_imag = F.pad(imag[:, 0], (0, 0, 1, 0))
        if self.masking_mode == "E":
            mask_mags = torch.sqrt(mask_real**2 + mask_imag**2)
            mask_phase = torch.atan2(mask_imag / (mask_mags + 1e-8),
                                     mask_real / (mask_mags + 1e-8))
            est_mags = torch.tanh(mask_mags) * mags
            est_phase = phase + mask_phase
            out_r, out_i = est_mags * torch.cos(est_phase), est_mags * torch.sin(est_phase)
        elif self.masking_mode == "C":
            out_r = real_s * mask_real - imag_s * mask_imag
            out_i = real_s * mask_imag + imag_s * mask_real
        else:  # "R"
            out_r, out_i = real_s * mask_real, imag_s * mask_imag
        out = conv_istft(out_r, out_i, self.win_len, self.win_inc, self.fft_len, length)
        return torch.clamp(out, -1.0, 1.0)
