"""Small audio and list helpers (a copy of the JAX package's
``utils/audio.py``), and PCM16 quantisation on numpy arrays or tensors.

The level and loudness math lives in ``ops.levels`` / ``ops.loudness``.
"""

from __future__ import annotations

from itertools import product
from typing import Any, Sequence

import numpy as np
import torch


def normalize(audio: np.ndarray, norm: str = "peak") -> np.ndarray:
    """Peak or RMS normalization. The rms variant: RMS over the signal with
    trailing zeros trimmed, scaled by 100 (the reference's convention)."""
    audio = np.asarray(audio)
    if norm == "peak":
        peak = np.abs(audio).max()
        return audio / peak if peak != 0 else audio
    if norm == "rms":
        trimmed = np.trim_zeros(audio, trim="b")
        rms = float(np.sqrt(np.mean(np.square(trimmed)))) * 100 if trimmed.size else 0.0
        return audio / rms if rms != 0 else audio
    raise NotImplementedError(f"unknown norm {norm!r}")


def clip_all(audio_list: Sequence[np.ndarray]) -> list[np.ndarray]:
    """Truncate every signal to the shortest length."""
    n = min(a.shape[-1] for a in audio_list)
    return [a[..., :n] for a in audio_list]


def clip_two(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Truncate the longer of two signals."""
    n = min(a.shape[-1], b.shape[-1])
    return a[..., :n], b[..., :n]


def sum_arrays_with_different_length(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """Zero-pad to the longest, then sum."""
    n = max(a.shape[-1] for a in arrays)
    out = np.zeros(arrays[0].shape[:-1] + (n,), dtype=np.result_type(*arrays))
    for a in arrays:
        out[..., : a.shape[-1]] += a
    return out


def pad_x_to_y(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Pad or crop x's last axis to y's length."""
    diff = y.shape[-1] - x.shape[-1]
    if diff > 0:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, diff)]
        return np.pad(x, pad)
    return x[..., : y.shape[-1]]


def make_pad_mask(lengths, max_len: int | None = None) -> np.ndarray:
    """(B,) lengths → (B, T) bool mask, True at padded positions."""
    lengths = np.asarray(lengths)
    t = int(max_len if max_len is not None else lengths.max())
    return np.arange(t)[None, :] >= lengths[:, None]


def all_pairs(list1: Sequence[Any], list2: Sequence[Any]) -> tuple[list, list]:
    """Cartesian product as two aligned lists."""
    pairs = list(product(list1, list2))
    if not pairs:
        return [], []
    a, b = zip(*pairs)
    return list(a), list(b)


def pcm16_exact(x: np.ndarray) -> np.ndarray | None:
    """int16 codes reproducing float array ``x`` exactly (``q · 2^-15``
    round-trips bit for bit in float32), or None if any sample is off the
    PCM16 grid or at or over full scale. Decides whether audio is uploaded
    as int16 (half the bytes) or float32, for the assembled tracks
    (dataset/generate.py) and the utterance cache
    (dataset/device_assembly.py) alike."""
    x = np.asarray(x)
    if x.size == 0:
        return x.astype(np.int16)
    if float(np.max(np.abs(x))) >= 32767.5 / 32768.0:
        return None
    q = np.rint(x * 32768.0)
    if np.array_equal(q.astype(np.float32) * np.float32(2.0**-15), x):
        return q.astype(np.int16)
    return None


def pcm16_quantize(x):
    """Float waveform → int16 PCM samples: clip to [-1, 1 − 2^-15], scale by
    32768, truncate toward zero. On a tensor it runs on the tensor's device;
    the codes equal ``utils.wavio.write_wav``'s host quantisation bit for
    bit."""
    if torch.is_tensor(x):
        return (torch.clamp(x, -1.0, 1.0 - 1.0 / 32768.0) * 32768.0).to(torch.int16)
    return (np.clip(x, -1.0, 1.0 - 1.0 / 32768.0) * 32768.0).astype(np.int16)
