"""PyanNet neural VAD in PyTorch (port of ``sonicsim_tpu.models.pyannet``).

The reference segments eval mixtures with pyannote's voice-activity
pipeline (separation/test.py:58-87: PyanNet segmentation + hysteresis
binarisation). The port keeps the JAX package's model under pyannote's
parameter names (``sincnet.conv1d.0.filterbank.low_hz_``, ``lstm.*``,
``linear.{i}``, ``classifier``), channel-first:

* SincNet — learned band-pass sinc filters (low and band cutoffs, a
  half-Hamming window at SincNet's non-integer points) at stride 10, abs,
  three blocks of VALID max-pool 3, affine instance norm and leaky ReLU;
* a stacked BiLSTM (``zoo_layers.LSTMLayer``; a pyannote checkpoint's
  ``bias_ih`` and ``bias_hh`` both load and add, ROADMAP C11), leaky-ReLU
  feed-forward layers and a sigmoid classifier per frame;
* :func:`binarize_activations` — pyannote's Binarize (onset/offset
  hysteresis, minimum durations, padding);
* :func:`make_neural_vad` — ``vad_fn(wav, sample_rate) -> [(start, end)]``
  for ``infer.vad.segment_mixture``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..bridge import float32_tensors, resolve_device
from .gagnet import InstanceNorm
from .zoo_layers import LSTMLayer

LEAK = 0.01  # torch F.leaky_relu's default


def sinc_filters(low_hz: torch.Tensor, band_hz: torch.Tensor, kernel_size: int,
                 sample_rate: int, min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0) -> torch.Tensor:
    """(F,) learned cutoffs → (F, kernel_size) band-pass FIR bank (SincNet,
    Ravanelli & Bengio 2018)."""
    dev = low_hz.device
    low = min_low_hz + low_hz.abs()
    high = torch.clamp(low + min_band_hz + band_hz.abs(), min_low_hz, sample_rate / 2)
    half = (kernel_size - 1) // 2
    n = torch.arange(-half, 0, dtype=torch.float32, device=dev) / sample_rate  # left half, s
    # SincNet's half-Hamming window samples linspace(0, k/2 - 1, k//2):
    # NON-integer points for odd kernels (0..124.5 for k=251).
    n_lin = torch.linspace(0.0, kernel_size / 2 - 1, half, device=dev)
    window = 0.54 - 0.46 * torch.cos(2 * torch.pi * n_lin / kernel_size)
    f_low = 2 * torch.pi * low[:, None] * n[None, :]
    f_high = 2 * torch.pi * high[:, None] * n[None, :]
    # left = (sin(2π f2 t) − sin(2π f1 t)) / (π t) · w, centre 2·band, the
    # whole filter over 2·band.
    left = (torch.sin(f_high) - torch.sin(f_low)) / (torch.pi * n)[None, :] * window[None, :]
    band = (high - low)[:, None]
    filt = torch.cat([left, 2 * band, left.flip(1)], dim=1)
    return filt / (2 * band)


class _SincFilterbank(nn.Module):
    """The learned cutoffs, under pyannote's ``filterbank.low_hz_`` and
    ``filterbank.band_hz_``."""

    def __init__(self, n_filters: int):
        super().__init__()
        self.low_hz_ = nn.Parameter(torch.linspace(0.0, 40.0, n_filters))
        self.band_hz_ = nn.Parameter(torch.full((n_filters,), 10.0))


class SincConv(nn.Module):
    """(B, 1, T) → (B, F, T') sinc filters, VALID, at ``stride``."""

    def __init__(self, n_filters: int = 80, kernel_size: int = 251, stride: int = 10,
                 sample_rate: int = 16000):
        super().__init__()
        self.kernel_size, self.stride, self.sample_rate = kernel_size, stride, sample_rate
        self.filterbank = _SincFilterbank(n_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fb = self.filterbank
        filt = sinc_filters(fb.low_hz_, fb.band_hz_, self.kernel_size, self.sample_rate)
        return F.conv1d(x, filt[:, None, :], stride=self.stride)


class SincNet(nn.Module):
    """pyannote blocks/sincnet.py's forward, channel-first: (B, T) →
    (B, 60, T')."""

    def __init__(self, stride: int = 10, sample_rate: int = 16000):
        super().__init__()
        self.wav_norm1d = InstanceNorm(1)
        self.conv1d = nn.ModuleList([SincConv(stride=stride, sample_rate=sample_rate),
                                     nn.Conv1d(80, 60, 5), nn.Conv1d(60, 60, 5)])
        self.norm1d = nn.ModuleList([InstanceNorm(80), InstanceNorm(60), InstanceNorm(60)])

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.wav_norm1d(wav[:, None, :])
        for i, (conv, norm) in enumerate(zip(self.conv1d, self.norm1d)):
            x = conv(x)
            if i == 0:
                x = x.abs()
            x = F.leaky_relu(norm(F.max_pool1d(x, 3, 3)), LEAK)
        return x


class PyanNet(nn.Module):
    """SincNet → stacked BiLSTM → leaky-ReLU FF layers → sigmoid frame
    activations: (B, T) → (B, frames, n_classes), on ``device`` (the card
    unless given)."""

    def __init__(self, n_classes: int = 1, lstm_hidden: int = 128, lstm_layers: int = 2,
                 ff_layers: int = 2, sample_rate: int = 16000, device=None):
        super().__init__()
        self.sample_rate = sample_rate
        with torch.device(resolve_device(device)):
            self.sincnet = SincNet(sample_rate=sample_rate)
            self.lstm = LSTMLayer(60, lstm_hidden, bidirectional=True, num_layers=lstm_layers)
            self.linear = nn.ModuleList(
                nn.Linear(2 * lstm_hidden if i == 0 else lstm_hidden, lstm_hidden)
                for i in range(ff_layers))
            self.classifier = nn.Linear(lstm_hidden, n_classes)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.lstm(self.sincnet(wav).transpose(1, 2))
        for lin in self.linear:
            x = F.leaky_relu(lin(x), LEAK)
        return torch.sigmoid(self.classifier(x))

    def frame_times(self, n_samples: int) -> np.ndarray:
        """Centre time (s) of each output frame. Each conv/pool stage maps an
        arithmetic sequence of centres to another (the mean of k
        consecutive terms is the middle one), so the cascade is closed-form
        (offset, step, length) bookkeeping."""
        offset, step, length = 0.0, 1.0, n_samples
        for k, s in ((251, 10), (3, 3), (5, 1), (3, 3), (5, 1), (3, 3)):
            offset += step * (k - 1) / 2.0
            length = (length - k) // s + 1
            step *= s
        pos = offset + step * np.arange(max(length, 0), dtype=np.float64)
        return pos / self.sample_rate


def binarize_activations(probs: np.ndarray, frame_times: np.ndarray, onset: float = 0.5,
                         offset: float = 0.5, min_duration_on: float = 0.0,
                         min_duration_off: float = 0.0, pad_onset: float = 0.0,
                         pad_offset: float = 0.0) -> list[tuple[float, float]]:
    """pyannote.audio Binarize: hysteresis thresholding with minimum
    durations and padding → [(start_s, end_s)]."""
    spans: list[list[float]] = []
    active = False
    start = 0.0
    for t, p in zip(frame_times, probs):
        if not active and p > onset:
            active, start = True, t
        elif active and p < offset:
            spans.append([start, t])
            active = False
    if active:
        spans.append([start, float(frame_times[-1])])
    spans = [[s - pad_onset, e + pad_offset] for s, e in spans]
    merged: list[list[float]] = []  # fill short gaps
    for s, e in spans:
        if merged and s - merged[-1][1] < min_duration_off:
            merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(max(s, 0.0), e) for s, e in merged if e - s >= min_duration_on]  # drop short ones


def pyannet_from_state_dict(sd: dict, device=None) -> PyanNet:
    """A pyannote PyanNet state dict (lightning ``model.`` prefix or bare;
    the cutoffs under ``filterbank.`` or not, any shape) → :class:`PyanNet`
    on ``device`` (the card unless given), its depth and widths read off the
    weights."""
    sd = float32_tensors({k.removeprefix("model."): v for k, v in sd.items()})
    for name in ("low_hz_", "band_hz_"):
        bare = sd.pop(f"sincnet.conv1d.0.{name}", None)
        key = f"sincnet.conv1d.0.filterbank.{name}"
        sd[key] = (sd[key] if bare is None else bare).reshape(-1)
    n_lstm = len([k for k in sd if k.startswith("lstm.weight_ih_l") and
                  not k.endswith("_reverse")])
    n_ff = len({k.split(".")[1] for k in sd if k.startswith("linear.")})
    model = PyanNet(n_classes=sd["classifier.weight"].shape[0],
                    lstm_hidden=sd["lstm.weight_ih_l0"].shape[0] // 4,
                    lstm_layers=max(n_lstm, 1), ff_layers=max(n_ff, 1), device="meta")
    model.load_state_dict(sd, assign=True)
    return model.to(resolve_device(device)).eval()


def make_neural_vad(checkpoint_path, onset: float = 0.5, offset: float = 0.5,
                    min_duration_on: float = 0.0, min_duration_off: float = 0.0,
                    device=None):
    """``vad_fn(wav, sample_rate) -> [(start_sample, end_sample)]`` over a
    pyannote PyanNet checkpoint run on ``device`` (the card unless given),
    for ``infer.vad.segment_mixture``'s ``vad_fn`` hook; speech is the
    largest class activation of a frame."""
    sd = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model = pyannet_from_state_dict(sd, device)
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def vad_fn(wav, sample_rate=16000):
        wav = np.asarray(wav, np.float32).reshape(-1)
        if sample_rate != model.sample_rate:
            from ..utils.wavio import resample

            wav = resample(wav, sample_rate, model.sample_rate)
        probs = model(torch.from_numpy(np.ascontiguousarray(wav))[None].to(dev))[0]
        speech = probs.amax(dim=-1).cpu().numpy()  # any-class activity
        spans = binarize_activations(speech, model.frame_times(len(wav)), onset, offset,
                                     min_duration_on, min_duration_off)
        return [(int(s * sample_rate), int(e * sample_rate)) for s, e in spans]

    vad_fn.model = model
    return vad_fn
