"""STFT/iSTFT with torch.stft-compatible semantics.

Port of ``sonicsim_tpu.ops.stft``: center=True with reflect padding, a Hann
window, one-sided, output (..., freq, frames); the inverse normalises the
overlap-add by the summed squared window and crops ``[pad : pad + length]``
as the JAX package does (which recovers the tail where ``torch.istft``
would zero-pad it).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..bridge import resolve_device


def hann_window(n: int, periodic: bool = True, device=None) -> torch.Tensor:
    """torch.hann_window parity (periodic by default), float32 on ``device``
    (the card unless given)."""
    device = resolve_device(device)
    m = n if periodic else n - 1
    if m <= 0:
        return torch.ones((max(n, 0),), dtype=torch.float32, device=device)
    k = np.arange(n)
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * k / m)).astype(np.float32)
    return torch.from_numpy(w).to(device)


def sqrt_hann_window(n: int, periodic: bool = True, device=None) -> torch.Tensor:
    return torch.sqrt(hann_window(n, periodic, device))


def stft(x: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor,
         center: bool = True, onesided: bool = True) -> torch.Tensor:
    """(..., T) → complex (..., F, frames); torch.stft(return_complex=True)
    parity."""
    if center:
        pad = n_fft // 2
        x = torch.cat([x[..., 1:pad + 1].flip(-1), x, x[..., -pad - 1:-1].flip(-1)], dim=-1)
    frames = x.unfold(-1, n_fft, hop_length) * window  # (..., frames, n_fft)
    spec = torch.fft.rfft(frames) if onesided else torch.fft.fft(frames)
    return spec.transpose(-1, -2)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(N, frames, n_fft) → (N, n_fft + hop·(frames − 1)), overlaps summed."""
    n, n_frames, n_fft = frames.shape
    t_pad = n_fft + hop_length * (n_frames - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, t_pad),
                 kernel_size=(1, n_fft), stride=(1, hop_length))
    return out.reshape(n, t_pad)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor,
          center: bool = True, length: int | None = None) -> torch.Tensor:
    """Inverse of ``stft`` (one-sided): (..., F, frames) → (..., T)."""
    frames = torch.fft.irfft(spec.transpose(-1, -2), n_fft) * window  # (..., frames, n_fft)
    batch, n_frames = frames.shape[:-2], frames.shape[-2]
    out = _overlap_add(frames.reshape(-1, n_frames, n_fft), hop_length)
    out = out.reshape(*batch, out.shape[-1])
    # The envelope in float32, or in the frames' dtype where that is wider.
    wsq = (window * window).to(torch.promote_types(frames.dtype, torch.float32))
    wsq = wsq.expand(1, n_frames, n_fft)
    denom = _overlap_add(wsq, hop_length)[0]
    out = out / torch.clamp(denom, min=1e-11)
    t_pad = out.shape[-1]
    if center:
        pad = n_fft // 2
        # Crop [pad : pad + length]: unlike torch.istft (which crops
        # [pad : t_pad − pad] then zero-pads), this recovers the true tail
        # samples when the signal length is not a hop multiple.
        out = out[..., pad:pad + length] if length is not None else out[..., pad:t_pad - pad]
    if length is not None:
        out = out[..., :length]
        if out.shape[-1] < length:
            out = F.pad(out, (0, length - out.shape[-1]))
    return out
