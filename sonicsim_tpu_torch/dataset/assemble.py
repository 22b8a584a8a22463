"""Plan executors: materialise long-audio plans and render single sources.

Port of the JAX package's ``dataset/assemble.py``. The host reads and places
WAVs (numpy); the moving and static reverbs and the loudness normalisation
run on a device through the port's ``ops``. Generation uses the renderers
only on its path for a trajectory of a single waypoint
(``generate.dispatch_mixture``).

Device: tensor inputs keep theirs; numpy inputs go to ``device``, the card
unless it names another (``bridge.resolve_device``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bridge import resolve_device
from ..ops import (
    block_plan_sizes,
    convolve_fixed_receiver,
    convolve_moving_blocked,
    dynamic_interp_plan,
    lufs_norm,
    moving_block_plan,
    segment_plan,
)
from ..utils.wavio import read_wav, resample
from .plan import LongAudioPlan


def assemble_long_audio(
    plan: LongAudioPlan, mono_downmix: bool = True
) -> np.ndarray:
    """LongAudioPlan → (1, total_samples) float32 buffer."""
    out = np.zeros((1, plan.total_samples), np.float32)
    for p in plan.placements:
        wav, sr = read_wav(p.path)
        if sr != plan.sample_rate:
            wav = resample(wav, sr, plan.sample_rate)
        if mono_downmix and wav.shape[0] > 1:
            wav = wav.mean(axis=0, keepdims=True)
        seg = wav[:, p.src_start : p.src_start + p.length]
        out[:, p.dest_start : p.dest_start + seg.shape[-1]] += seg[0]
    return out


def _device_of(x, device) -> torch.device:
    return x.device if torch.is_tensor(x) else resolve_device(device)


def _f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device).to(torch.float32)


def render_moving_source(
    source_audio,  # (T,) or (1, T)
    rir_bank,  # (P, C, L): one RIR per trajectory waypoint
    waypoints: np.ndarray,  # (P, 3)
    rng: np.random.Generator,
    device=None,
) -> np.ndarray:
    """Trajectory-crossfaded reverb → (C, T) numpy, through the blocked
    moving convolution with the fused crossfade. A bank of one RIR (a
    single waypoint) is a plain fixed convolution and draws nothing from
    ``rng``. (The reference plans the trajectory first, which raises for a
    single waypoint; ROADMAP C.)"""
    dev = _device_of(rir_bank, device)
    audio = _f32(source_audio, dev).reshape(-1)
    bank = _f32(rir_bank, dev)
    if bank.shape[0] < 2:
        return convolve_fixed_receiver(audio, bank[0]).cpu().numpy()
    t = audio.shape[-1]
    idx, _ = dynamic_interp_plan(np.asarray(waypoints), t, rng=rng)
    offsets, lengths, max_seg = segment_plan(idx)
    block, nb = block_plan_sizes(max_seg, t, len(offsets))
    block_off, block_seg = moving_block_plan(offsets, lengths, t, block, nb)
    out = convolve_moving_blocked(
        audio, bank, None, block_off, block_seg, block,
        seg_offsets=offsets, seg_lengths=lengths,
    )
    return out.cpu().numpy()


def render_static_source(source_audio, rir, device=None) -> np.ndarray:
    """(T,) ⊛ (C, L) → (C, T) numpy (``convolve_fixed_receiver``)."""
    dev = _device_of(rir, device)
    return convolve_fixed_receiver(
        _f32(source_audio, dev).reshape(-1), _f32(rir, dev)
    ).cpu().numpy()


def loudness_normalize_to(
    audio, sample_rate: int, target_lufs: float, device=None
) -> tuple[np.ndarray, float]:
    """(C, T) → LUFS-normalised (C, T) numpy and the gain; the target
    already includes the planner's jitter."""
    out, gain = lufs_norm(_f32(audio, _device_of(audio, device)), sample_rate,
                          target_lufs)
    return out.cpu().numpy(), float(gain)
