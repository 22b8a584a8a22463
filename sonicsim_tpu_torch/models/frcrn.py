"""FRCRN (frequency-recurrent CRN with complex FSMNs) in PyTorch.

Port of ``sonicsim_tpu.models.frcrn`` (reference
enhancement/look2hear/models/frcrn.py:12-540 and complex_nn.py; config
configs/enhancement/frcrn.yaml: complex, depth 14, window 640 / hop 320 /
FFT 640): the conv-STFT (sqrt-Hann, no padding), two cascaded complex UNets
(7 frequency-stride-2 complex conv layers with SE attention and
frequency-direction complex FSMNs, a complex FSMN over time at the
bottleneck), two tanh complex masks (the second refines the first), and the
masked spectra and waveforms. Returns the reference's
``(inputs, [est_spec1, est_wav1, est_mask1, est_spec2, est_wav2,
est_mask2])``; ``output[1][4]`` is the refined waveform.

Parameter names are the reference's (``unet``/``unet2``: ``encoder{i}.
{conv.conv_re,conv.conv_im,bn.bn_re,bn.bn_im}``, ``decoder{i}.{transconv.
tconv_re,transconv.tconv_im,bn.bn_re,bn.bn_im}``, ``se_layer_enc{i}``,
``se_layer_dec{i}``, ``fsmn_enc{i}``, ``fsmn_dec{i}``, ``fsmn``,
``linear``); each layout is (B, C, F, T). The FSMN memory is the
reference's depthwise Conv2d (C, 1, lorder, 1). The BatchNorms run on batch
statistics unless ``torch_compat`` (frozen running statistics).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import BaseModel, register_model
from .dccrn import conv_istft, conv_stft
from .zoo_layers import StatelessBatchNorm

# model_depth=14 layer tables (frcrn.py:323-346): (freq, time) kernels; the
# padding is (0, 1), time on both sides.
ENC_KERNELS = [(5, 2)] * 6 + [(2, 2)]
DEC_KERNELS = [(2, 2), (5, 2), (5, 2), (5, 2), (6, 2), (5, 2), (5, 2)]
DEPTH, WIDTH = 7, 128


class UniDeepFsmn(nn.Module):
    """A residual causal depthwise memory over the sequence axis
    (complex_nn.py:57-95), (N, L, dim) → same: ``linear``, ``project``,
    ``conv1``."""

    def __init__(self, dim: int = WIDTH, lorder: int = 20, hidden_size: int = WIDTH):
        super().__init__()
        self.lorder = lorder
        self.linear = nn.Linear(dim, hidden_size)
        self.project = nn.Linear(hidden_size, dim, bias=False)
        self.conv1 = nn.Conv2d(dim, dim, (lorder, 1), groups=dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p1 = self.project(torch.relu(self.linear(x)))
        y = F.pad(p1.transpose(1, 2)[..., None], (0, 0, self.lorder - 1, 0))
        return x + p1 + self.conv1(y)[..., 0].transpose(1, 2)


class _ComplexFsmn(nn.Module):
    """The complex FSMN pairs: ``fsmn_re_L{k}``, ``fsmn_im_L{k}``."""

    def __init__(self, layers: int):
        super().__init__()
        for k in range(1, layers + 1):
            self.add_module(f"fsmn_re_L{k}", UniDeepFsmn())
            self.add_module(f"fsmn_im_L{k}", UniDeepFsmn())
        self.layers = layers

    def run(self, rr: torch.Tensor, ii: torch.Tensor):
        for k in range(1, self.layers + 1):
            fr, fi = getattr(self, f"fsmn_re_L{k}"), getattr(self, f"fsmn_im_L{k}")
            rr, ii = fr(rr) - fi(ii), fr(ii) + fi(rr)
        return rr, ii


class ComplexFSMN(_ComplexFsmn):
    """ComplexUniDeepFsmn (complex_nn.py:202-241): two complex FSMN layers
    over time, on (B, C, F, T) pairs, the (C, F) axes flattened per frame."""

    def __init__(self):
        super().__init__(2)

    def forward(self, re: torch.Tensor, im: torch.Tensor):
        b, c, f, t = re.shape

        def seq(z):  # (B, T, F·C), frequency-major as the JAX model reads it
            return z.permute(0, 3, 2, 1).reshape(b, t, f * c)

        rr, ii = self.run(seq(re), seq(im))
        back = lambda z: z.reshape(b, t, f, c).permute(0, 3, 2, 1)  # noqa: E731
        return back(rr), back(ii)


class ComplexFSMNFreq(_ComplexFsmn):
    """ComplexUniDeepFsmn_L1 (complex_nn.py:243-268): one complex FSMN layer
    along frequency per frame, on (B, C, F, T) pairs."""

    def __init__(self):
        super().__init__(1)

    def forward(self, re: torch.Tensor, im: torch.Tensor):
        b, c, f, t = re.shape

        def seq(z):  # (B·T, F, C)
            return z.permute(0, 3, 2, 1).reshape(b * t, f, c)

        rr, ii = self.run(seq(re), seq(im))
        back = lambda z: z.reshape(b, t, f, c).permute(0, 3, 2, 1)  # noqa: E731
        return back(rr), back(ii)


class SELayer(nn.Module):
    """Complex squeeze-excitation (frcrn.py:12-33): ``fc_r``, ``fc_i``."""

    def __init__(self, channel: int = WIDTH, reduction: int = 8):
        super().__init__()

        def gate():
            return nn.Sequential(nn.Linear(channel, channel // reduction), nn.ReLU(),
                                 nn.Linear(channel // reduction, channel), nn.Sigmoid())

        self.fc_r, self.fc_i = gate(), gate()

    def forward(self, re: torch.Tensor, im: torch.Tensor):
        xr, xi = re.mean(dim=(2, 3)), im.mean(dim=(2, 3))  # (B, C)
        yr = self.fc_r(xr) - self.fc_i(xi)
        yi = self.fc_r(xi) + self.fc_i(xr)
        return re * yr[:, :, None, None], im * yi[:, :, None, None]


class _ComplexBN(nn.Module):
    def __init__(self, dim: int, torch_compat: bool):
        super().__init__()
        self.bn_re = StatelessBatchNorm(dim, use_running_stats=torch_compat)
        self.bn_im = StatelessBatchNorm(dim, use_running_stats=torch_compat)

    def forward(self, re: torch.Tensor, im: torch.Tensor):
        def norm(bn, z):
            return F.leaky_relu(bn(z.movedim(1, -1)).movedim(-1, 1), 0.01)

        return norm(self.bn_re, re), norm(self.bn_im, im)


class _Pair(nn.Module):
    def __init__(self, re: nn.Module, im: nn.Module, names: tuple[str, str]):
        super().__init__()
        self.names = names
        self.add_module(names[0], re)
        self.add_module(names[1], im)

    def forward(self, re: torch.Tensor, im: torch.Tensor):
        cr, ci = (getattr(self, n) for n in self.names)
        return cr(re) - ci(im), cr(im) + ci(re)


class ComplexEncoderLayer(nn.Module):
    """Complex conv (stride (2, 1), time padded by 1 on both sides), the
    BatchNorms, LeakyReLU 0.01: ``conv.conv_{re,im}``, ``bn.bn_{re,im}``."""

    def __init__(self, cin: int, cout: int, kernel, torch_compat: bool):
        super().__init__()
        self.conv = _Pair(nn.Conv2d(cin, cout, kernel, stride=(2, 1)),
                          nn.Conv2d(cin, cout, kernel, stride=(2, 1)), ("conv_re", "conv_im"))
        self.bn = _ComplexBN(cout, torch_compat)

    def forward(self, re: torch.Tensor, im: torch.Tensor):
        return self.bn(*self.conv(F.pad(re, (1, 1)), F.pad(im, (1, 1))))


class ComplexDecoderLayer(nn.Module):
    """Complex transposed conv (stride (2, 1)) with one frame cropped from
    each end of time, the BatchNorms, LeakyReLU 0.01:
    ``transconv.tconv_{re,im}``, ``bn.bn_{re,im}``."""

    def __init__(self, cin: int, cout: int, kernel, torch_compat: bool):
        super().__init__()
        self.transconv = _Pair(nn.ConvTranspose2d(cin, cout, kernel, stride=(2, 1)),
                               nn.ConvTranspose2d(cin, cout, kernel, stride=(2, 1)),
                               ("tconv_re", "tconv_im"))
        self.bn = _ComplexBN(cout, torch_compat)

    def forward(self, re: torch.Tensor, im: torch.Tensor):
        rr, ii = self.transconv(re, im)
        return self.bn(rr[..., 1:-1], ii[..., 1:-1])


class FRCRNUNet(nn.Module):
    """The depth-14 complex UNet (frcrn.py:216-321), on (B, C, F, T) pairs."""

    def __init__(self, torch_compat: bool = False):
        super().__init__()
        for i in range(DEPTH):
            if i > 0:
                self.add_module(f"fsmn_enc{i}", ComplexFSMNFreq())
            self.add_module(f"encoder{i}", ComplexEncoderLayer(
                1 if i == 0 else WIDTH, WIDTH, ENC_KERNELS[i], torch_compat))
            self.add_module(f"se_layer_enc{i}", SELayer())
        self.fsmn = ComplexFSMN()
        for i in range(DEPTH):
            self.add_module(f"decoder{i}", ComplexDecoderLayer(
                WIDTH if i == 0 else 2 * WIDTH, 1 if i == DEPTH - 1 else WIDTH, DEC_KERNELS[i],
                torch_compat))
            if i < DEPTH - 1:
                self.add_module(f"fsmn_dec{i}", ComplexFSMNFreq())
            if i < DEPTH - 2:
                self.add_module(f"se_layer_dec{i}", SELayer())
        self.linear = _Pair(nn.Conv2d(1, 1, 1), nn.Conv2d(1, 1, 1), ("conv_re", "conv_im"))

    def forward(self, re: torch.Tensor, im: torch.Tensor):
        skips, x = [], (re, im)
        for i in range(DEPTH):
            if i > 0:
                x = getattr(self, f"fsmn_enc{i}")(*x)
            x = getattr(self, f"encoder{i}")(*x)
            skips.append(getattr(self, f"se_layer_enc{i}")(*x))  # the skip alone is attended
        p = self.fsmn(*x)
        for i in range(DEPTH):
            p = getattr(self, f"decoder{i}")(*p)
            if i == DEPTH - 1:
                break
            p = getattr(self, f"fsmn_dec{i}")(*p)
            if i < DEPTH - 2:
                p = getattr(self, f"se_layer_dec{i}")(*p)
            sr, si = skips[DEPTH - 2 - i]
            f, t = sr.shape[2], sr.shape[3]
            p = (torch.cat([p[0][:, :, :f, :t], sr], dim=1),
                 torch.cat([p[1][:, :, :f, :t], si], dim=1))
        return self.linear(*p)


@register_model
class FRCRN(BaseModel):
    """Keyword names are the JAX package's fields (frcrn.yaml); the widths
    are the depth-14 variant's, as in the JAX package. Built on ``device``:
    the card unless the caller names another."""

    def __init__(self, complex: bool = True, model_complexity: int = 45, model_depth: int = 14,
                 log_amp: bool = False, padding_mode: str = "zeros", win_len: int = 640,
                 win_inc: int = 320, fft_len: int = 640, win_type: str = "hann",
                 sample_rate: int = 16000, torch_compat: bool = False, *, device=None):
        super().__init__(dict(complex=complex, model_complexity=model_complexity,
                              model_depth=model_depth, log_amp=log_amp,
                              padding_mode=padding_mode, win_len=win_len, win_inc=win_inc,
                              fft_len=fft_len, win_type=win_type, sample_rate=sample_rate,
                              torch_compat=torch_compat))
        self.win_len, self.win_inc, self.fft_len = win_len, win_inc, fft_len
        self.unet = FRCRNUNet(torch_compat)
        self.unet2 = FRCRNUNet(torch_compat)
        self.place(device)

    def forward(self, wav: torch.Tensor):
        if wav.dim() == 1:
            wav = wav[None, :]
        length = wav.shape[-1]
        real, imag = conv_stft(wav, self.win_len, self.win_inc, self.fft_len,
                               sqrt_window=True, pad_signal=False)
        u1 = self.unet(real[:, None], imag[:, None])
        mask1 = (torch.tanh(u1[0]), torch.tanh(u1[1]))
        u2 = self.unet2(*u1)
        mask2 = (torch.tanh(u2[0]) + mask1[0], torch.tanh(u2[1]) + mask1[1])

        def apply(mask):
            f = real.shape[1]
            mr, mi = mask[0][:, 0, :f], mask[1][:, 0, :f]  # (B, F, T)
            est_r, est_i = real * mr - imag * mi, real * mi + imag * mr
            est_wav = conv_istft(est_r, est_i, self.win_len, self.win_inc, self.fft_len,
                                 length, sqrt_window=True, crop_pad=False)
            return torch.cat([est_r, est_i], dim=1), est_wav, torch.cat([mr, mi], dim=1)

        return wav, [*apply(mask1), *apply(mask2)]
