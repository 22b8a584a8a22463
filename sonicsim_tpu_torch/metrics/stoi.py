"""STOI (short-time objective intelligibility), NumPy implementation.

Replaces pystoi (used by the reference eval battery,
separation/look2hear/metrics/wrapper.py:106). Classic STOI
[Taal et al., 2010]: resample to 10 kHz, drop silent frames, 1/3-octave band
energies over 512-pt STFT frames, 384 ms (30-frame) segments, normalized +
clipped correlation averaged over bands and segments.
"""

from __future__ import annotations

import numpy as np

from ..utils.wavio import resample

FS = 10000  # internal rate
N_FFT = 512
HOP = 128  # 50% overlap (classic STOI / pystoi framing)
WIN = 256
NUM_BANDS = 15
MIN_FREQ = 150.0
SEG_LEN = 30  # frames per segment (384 ms at hop 128: 30 x 12.8 ms)
BETA = -15.0  # clipping: -15 dB SDR bound
DYN_RANGE = 40.0  # silent-frame removal threshold


def _thirdoct_matrix() -> tuple[np.ndarray, np.ndarray]:
    f = np.linspace(0, FS, N_FFT + 1)[: N_FFT // 2 + 1]
    k = np.arange(NUM_BANDS)
    cf = MIN_FREQ * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((NUM_BANDS, len(f)))
    for i in range(NUM_BANDS):
        lo_i = int(np.argmin((f - lo[i]) ** 2))
        hi_i = int(np.argmin((f - hi[i]) ** 2))
        obm[i, lo_i:hi_i] = 1.0
    return obm, cf


def _stft_frames(x: np.ndarray) -> np.ndarray:
    w = np.hanning(WIN + 2)[1:-1]
    n_frames = max((len(x) - WIN) // HOP + 1, 0)
    frames = np.zeros((n_frames, N_FFT))
    for i in range(n_frames):
        frames[i, :WIN] = x[i * HOP : i * HOP + WIN] * w
    return np.fft.rfft(frames, N_FFT, axis=-1)


def _remove_silent_frames(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    w = np.hanning(WIN + 2)[1:-1]
    n_frames = max((len(x) - WIN) // HOP + 1, 0)
    energies = np.array(
        [
            20.0
            * np.log10(np.linalg.norm(x[i * HOP : i * HOP + WIN] * w) + 1e-12)
            for i in range(n_frames)
        ]
    )
    mask = energies > (energies.max() - DYN_RANGE) if n_frames else np.array([], bool)
    xs = np.zeros_like(x[: n_frames * HOP + WIN])
    ys = np.zeros_like(xs)
    cursor = 0
    for i in np.flatnonzero(mask):
        xs[cursor : cursor + WIN] += x[i * HOP : i * HOP + WIN] * w
        ys[cursor : cursor + WIN] += y[i * HOP : i * HOP + WIN] * w
        cursor += HOP
    return xs[: cursor + WIN - HOP], ys[: cursor + WIN - HOP]


def stoi(ref: np.ndarray, est: np.ndarray, sample_rate: int) -> float:
    """STOI score in [~0, 1]; inputs are 1-D waveforms at ``sample_rate``."""
    ref = np.asarray(ref, np.float64).reshape(-1)
    est = np.asarray(est, np.float64).reshape(-1)
    n = min(len(ref), len(est))
    ref, est = ref[:n], est[:n]
    if sample_rate != FS:
        ref = resample(ref, sample_rate, FS).astype(np.float64)
        est = resample(est, sample_rate, FS).astype(np.float64)

    ref, est = _remove_silent_frames(ref, est)
    if len(ref) < WIN + HOP * (SEG_LEN - 1):
        return float("nan")  # too little active speech

    obm, _ = _thirdoct_matrix()
    spec_r = np.sqrt(obm @ (np.abs(_stft_frames(ref).T) ** 2))  # (bands, frames)
    spec_e = np.sqrt(obm @ (np.abs(_stft_frames(est).T) ** 2))

    n_frames = spec_r.shape[1]
    if n_frames < SEG_LEN:
        return float("nan")
    scores = []
    clip_factor = 10.0 ** (-BETA / 20.0)
    for m in range(SEG_LEN, n_frames + 1):
        xr = spec_r[:, m - SEG_LEN : m]
        xe = spec_e[:, m - SEG_LEN : m]
        alpha = np.linalg.norm(xr, axis=1, keepdims=True) / (
            np.linalg.norm(xe, axis=1, keepdims=True) + 1e-12
        )
        xe_n = np.minimum(xe * alpha, xr * (1.0 + clip_factor))
        xr_c = xr - xr.mean(axis=1, keepdims=True)
        xe_c = xe_n - xe_n.mean(axis=1, keepdims=True)
        num = np.sum(xr_c * xe_c, axis=1)
        den = np.linalg.norm(xr_c, axis=1) * np.linalg.norm(xe_c, axis=1) + 1e-12
        scores.append(num / den)
    return float(np.mean(scores))
