"""ITU-R BS.1770-4 loudness (LUFS) measurement and normalisation, in PyTorch.

Port of the JAX package's ``ops/loudness.py`` (pyloudnorm's meter,
SonicSim_audio.py:68-86): K-weighting (high-shelf + high-pass biquads), then
400 ms / 75%-overlap gated block energies with the −70 LKFS absolute and
−10 LU relative gates.

The default K-weighting is one FFT convolution with the truncated impulse
response of the two biquads, in 8192-point overlap-save blocks as in the
reference. ``k_weight(exact=True)`` runs the biquads as a sequential loop
(torch has no associative scan); it is a CPU reference path, not the main
one. Leading dims are batch: ``integrated_loudness`` takes (T,), (C, T) or
(..., C, T) and returns one value per (C, T) item.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

_SHELF = dict(g_db=3.999843853973347, f0=1681.974450955533, q=0.7071752369554196)
_HIGHPASS = dict(f0=38.13547087602444, q=0.5003270373238773)
_ABS_GATE_LUFS = -70.0
_REL_GATE_LU = -10.0
# Channel weights: L, R, C, Ls, Rs (BS.1770-4 table 3); unity beyond five.
_CH_WEIGHTS = np.array([1.0, 1.0, 1.0, 1.41, 1.41])
_KWEIGHT_NFFT = 8192


def k_weighting_coeffs(rate: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(b, a) for the two K-weighting biquads at the given sample rate."""
    coeffs = []
    # High shelf (RBJ cookbook, as used by BS.1770/pyloudnorm).
    a_gain = 10.0 ** (_SHELF["g_db"] / 40.0)
    w0 = 2.0 * math.pi * _SHELF["f0"] / rate
    alpha = math.sin(w0) / (2.0 * _SHELF["q"])
    cw = math.cos(w0)
    sq = 2.0 * math.sqrt(a_gain) * alpha
    b = np.array(
        [
            a_gain * ((a_gain + 1) + (a_gain - 1) * cw + sq),
            -2.0 * a_gain * ((a_gain - 1) + (a_gain + 1) * cw),
            a_gain * ((a_gain + 1) + (a_gain - 1) * cw - sq),
        ]
    )
    a = np.array(
        [
            (a_gain + 1) - (a_gain - 1) * cw + sq,
            2.0 * ((a_gain - 1) - (a_gain + 1) * cw),
            (a_gain + 1) - (a_gain - 1) * cw - sq,
        ]
    )
    coeffs.append((b / a[0], a / a[0]))
    # High pass.
    w0 = 2.0 * math.pi * _HIGHPASS["f0"] / rate
    alpha = math.sin(w0) / (2.0 * _HIGHPASS["q"])
    cw = math.cos(w0)
    b = np.array([(1 + cw) / 2.0, -(1 + cw), (1 + cw) / 2.0])
    a = np.array([1 + alpha, -2.0 * cw, 1 - alpha])
    coeffs.append((b / a[0], a / a[0]))
    return coeffs


def biquad(x: torch.Tensor, b, a) -> torch.Tensor:
    """Biquad IIR along the last axis, direct-form II transposed, as a
    sequential loop over samples (vectorised over leading dims)."""
    b0, b1, b2 = (float(v) for v in b)
    _, a1, a2 = (float(v) for v in a)
    x = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    s1 = x.new_zeros(x.shape[:-1])
    s2 = x.new_zeros(x.shape[:-1])
    out = torch.empty_like(x)
    for n in range(x.shape[-1]):
        xn = x[..., n]
        yn = b0 * xn + s1
        s1 = b1 * xn - a1 * yn + s2
        s2 = b2 * xn - a2 * yn
        out[..., n] = yn
    return out


@lru_cache(maxsize=8)
def _kweight_fir(rate: int, tol: float = 1e-8, max_len: int = 1 << 16) -> np.ndarray:
    """Truncated impulse response of the cascaded K-weighting biquads
    (|h| < tol dropped: below float32 resolution). Read-only."""
    from scipy.signal import lfilter

    h = np.zeros(max_len)
    h[0] = 1.0
    for b, a in k_weighting_coeffs(rate):
        h = lfilter(b, a, h)
    tail = np.nonzero(np.abs(h) > tol)[0]
    n = int(tail[-1]) + 1 if len(tail) else 1
    h = h[:n].astype(np.float32)
    h.flags.writeable = False
    return h


@lru_cache(maxsize=8)
def _kweight_spectrum(rate: int) -> np.ndarray:
    """rfft of the truncated response at the overlap-save block size."""
    s = np.fft.rfft(_kweight_fir(rate), _KWEIGHT_NFFT)
    s.flags.writeable = False
    return s


def k_weight(x: torch.Tensor, rate: int, exact: bool = False) -> torch.Tensor:
    """Apply the two-stage K-weighting filter along the last axis."""
    if exact:
        for b, a in k_weighting_coeffs(rate):
            x = biquad(x, b, a)
        return x
    l = len(_kweight_fir(rate))
    t = x.shape[-1]
    nfft = _KWEIGHT_NFFT
    step = nfft - (l - 1)
    n_blocks = -(-t // step)
    xpad = F.pad(x, (l - 1, n_blocks * step - t))
    blocks = xpad.unfold(-1, nfft, step)  # (..., n_blocks, nfft)
    cdtype = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    hf = torch.from_numpy(_kweight_spectrum(rate).copy()).to(
        device=x.device, dtype=cdtype
    )
    conv = torch.fft.irfft(torch.fft.rfft(blocks, nfft) * hf, nfft)
    out = conv[..., l - 1 :]  # valid part of each block: (..., n_blocks, step)
    return out.reshape(*x.shape[:-1], n_blocks * step)[..., :t]


def integrated_loudness(data: torch.Tensor, rate: int,
                        block_size: float = 0.4) -> torch.Tensor:
    """Gated integrated loudness in LUFS.

    data: (T,) mono, (C, T), or (..., C, T). Returns a scalar, or one value
    per leading index; silent input gives -inf like pyloudnorm.
    """
    x = data if data.dtype == torch.float64 else data.to(torch.float32)
    if x.dim() == 1:
        x = x[None]
    n_ch, t = x.shape[-2:]
    xw = k_weight(x, rate)

    block = int(round(block_size * rate))
    hop = max(int(round(block * 0.25)), 1)
    n_frames = max((t - block) // hop + 1, 1)

    if block == 4 * hop and t >= block:
        # 75%-overlap fast path: per-hop chunk energies + 4-chunk rolling sum.
        n_chunks = t // hop
        sq = xw[..., : n_chunks * hop] ** 2
        chunk_e = sq.reshape(*sq.shape[:-1], n_chunks, hop).sum(-1)
        z = (
            chunk_e[..., :-3] + chunk_e[..., 1:-2] + chunk_e[..., 2:-1]
            + chunk_e[..., 3:]
        )[..., :n_frames] / block
    else:
        # General path: frame energies from cumulative sums.
        csum = F.pad(torch.cumsum(xw * xw, dim=-1), (1, 0))
        starts = torch.arange(n_frames, device=x.device) * hop
        z = (csum[..., starts + min(block, t)] - csum[..., starts]) / block

    weights = torch.as_tensor(
        np.concatenate(
            [_CH_WEIGHTS[:n_ch], np.ones(max(n_ch - len(_CH_WEIGHTS), 0))]
        ),
        dtype=x.dtype, device=x.device,
    )
    wz = torch.einsum("c,...cf->...f", weights, z)  # (..., n_frames)
    block_lufs = -0.691 + 10.0 * torch.log10(torch.clamp(wz, min=1e-30))

    abs_mask = block_lufs > _ABS_GATE_LUFS
    n_abs = torch.clamp(abs_mask.sum(-1), min=1)
    z_abs = torch.where(abs_mask, wz, 0.0).sum(-1) / n_abs
    rel_gate = (
        -0.691 + 10.0 * torch.log10(torch.clamp(z_abs, min=1e-30))
        + _REL_GATE_LU
    )
    mask = abs_mask & (block_lufs > rel_gate[..., None])
    n_sel = mask.sum(-1)
    z_avg = torch.where(mask, wz, 0.0).sum(-1) / torch.clamp(n_sel, min=1)
    lufs = -0.691 + 10.0 * torch.log10(torch.clamp(z_avg, min=1e-30))
    return torch.where(
        (n_sel > 0) & abs_mask.any(-1), lufs, torch.full_like(lufs, -math.inf)
    )


def loudness_normalize(data: torch.Tensor, measured_lufs, target_lufs):
    """Scale ``data`` from measured to target LUFS. Returns (audio, gain);
    ``gain`` has one value per leading (C, T) item of ``data``."""
    gain = torch.as_tensor(
        10.0 ** ((target_lufs - measured_lufs) / 20.0), device=data.device
    )
    g = gain.reshape(*gain.shape, *([1] * (data.dim() - gain.dim())))
    return data * g, gain


def lufs_norm(data: torch.Tensor, rate: int, target) -> tuple[torch.Tensor, torch.Tensor]:
    """Measure and normalise, with the reference's −40 LUFS fallback for
    silence and its block-size shrink for sub-400 ms audio
    (SonicSim_audio.py:68-81). ``target`` is a float or one per item."""
    t = data.shape[-1]
    block_size = 0.4 if t / rate >= 0.4 else t / rate
    measured = integrated_loudness(data, rate, block_size=block_size)
    measured = torch.where(
        torch.isfinite(measured), measured, torch.full_like(measured, -40.0)
    )
    target = torch.as_tensor(target, dtype=measured.dtype, device=measured.device)
    return loudness_normalize(data, measured, target)
