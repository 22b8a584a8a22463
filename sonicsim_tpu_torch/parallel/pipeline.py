"""The per-mixture render step of SonicSet generation.

Port of the JAX package's ``parallel/pipeline.py``: every speaker's moving
convolution, the static noise/music reverbs and all the BS.1770 loudness
normalisations of one mixture, batched over sources, on one device or
(``mesh=``) sharded over the source axes of a ``parallel.mesh.Mesh``.

Per-source trajectory plans have ragged shapes, so :func:`pad_moving_plans`
pads them to one shape: extra bank entries repeat the last RIR and extra
segments get offset = T, length = 0, which own no output sample.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bridge import resolve_device
from ..ops.fftconv import (
    block_plan_sizes,
    convolve_fixed_receiver,
    convolve_moving_blocked,
    moving_block_plan,
)
from ..ops.loudness import lufs_norm
from .mesh import gather, shard_slices


def pad_moving_plans(
    banks: list,
    weights: list[np.ndarray],
    offsets: list[np.ndarray],
    lengths: list[np.ndarray],
    stack_weights: bool = True,
) -> tuple:
    """Stack ragged per-source moving plans into common shapes.

    banks[i]: (P_i, C, L) numpy or tensor; weights[i]: (T,);
    offsets/lengths[i]: (P_i-1,). Returns (banks (S,P,C,L), weights (S,T) or
    None, offsets (S,P-1), lengths (S,P-1), max_seg) with P = max_i P_i
    rounded up to a multiple of 8 and max_seg to one of 8192. Banks stay
    tensors (on their device) if any is one; the rest is numpy.
    """
    t = int(weights[0].shape[-1])
    # A single-waypoint (static) bank becomes its exact 2-waypoint
    # equivalent: the RIR duplicated and one segment owning the signal.
    banks, offsets, lengths = list(banks), list(offsets), list(lengths)
    for i, b in enumerate(banks):
        if b.shape[0] == 1:
            banks[i] = torch.cat([b, b]) if torch.is_tensor(b) else np.concatenate([b, b])
            offsets[i] = np.zeros(1, np.int32)
            lengths[i] = np.full(1, t, np.int32)
    p = -(-max(b.shape[0] for b in banks) // 8) * 8
    on_device = any(torch.is_tensor(b) for b in banks)
    banks_p, off_p, len_p = [], [], []
    for b, o, le in zip(banks, offsets, lengths):
        extra = p - b.shape[0]
        if on_device:
            b = torch.as_tensor(b)
            if extra:
                b = torch.cat([b, b[-1:].expand(extra, *b.shape[1:])])
        elif extra:
            b = np.concatenate([b, np.repeat(b[-1:], extra, axis=0)])
        banks_p.append(b)
        pad = p - 1 - o.shape[0]
        off_p.append(np.concatenate([o, np.full(pad, t, o.dtype)]))
        len_p.append(np.concatenate([le, np.zeros(pad, le.dtype)]))
    max_seg = int(max(int(le.max()) for le in lengths))
    max_seg = -(-max_seg // 8192) * 8192
    if on_device:
        device = next(b.device for b in banks_p if torch.is_tensor(b))
        stacked = torch.stack([b.to(device) for b in banks_p]).to(torch.float32)
    else:
        stacked = np.stack(banks_p).astype(np.float32)
    return (
        stacked,
        np.stack(weights).astype(np.float32) if stack_weights else None,
        np.stack(off_p).astype(np.int32),
        np.stack(len_p).astype(np.int32),
        max_seg,
    )


def _weights_from_segments(offsets, lengths, mask, *, t: int, device=None):
    """Per-sample crossfade ramps (S, T) from the (S, P-1) segment table:
    (t − seg_start)/seg_len inside each segment, times ``mask`` (0 for a
    degenerate, zero-distance trajectory, whose host plan has zero
    weights)."""
    off = torch.as_tensor(offsets, device=device).to(torch.int64)
    le = torch.as_tensor(lengths, device=device).to(torch.int64)
    m = torch.as_tensor(mask, device=off.device, dtype=torch.float32)
    ts = torch.arange(t, device=off.device)
    ends = (off + le).contiguous()  # sorted: segments are contiguous
    seg = torch.searchsorted(
        ends, ts.expand(off.shape[0], t).contiguous(), right=True
    ).clamp(0, off.shape[1] - 1)
    num = torch.clamp(le.gather(1, seg), min=1).to(torch.float32)
    return (ts - off.gather(1, seg)).to(torch.float32) / num * m[:, None]


def _audio(x, device) -> torch.Tensor:
    """Audio to a float tensor: int16 PCM is i · 2^-15 (exact in float32)."""
    x = torch.as_tensor(x, device=device)
    if x.dtype == torch.int16:
        return x.to(torch.float32) * (1.0 / 32768.0)
    return x if x.dtype == torch.float64 else x.to(torch.float32)


def _render_moving(speech, banks, weights, block_off, block_seg, block, offsets,
                   lengths, mask, speech_lufs, sample_rate, device) -> torch.Tensor:
    """The moving sources of one device: the blocked conv (K1's ramp form
    with ``weights=None``, else K2's combine), then the loudness."""
    speech = _audio(speech, device)
    banks = torch.as_tensor(banks, device=device)
    if weights is None:
        moving = convolve_moving_blocked(
            speech, banks, None, block_off, block_seg, block,
            seg_offsets=offsets, seg_lengths=lengths,
            w_scale=torch.as_tensor(mask, device=device),
        )
    else:
        moving = convolve_moving_blocked(
            speech, banks, torch.as_tensor(weights, device=device),
            block_off, block_seg, block,
        )
    return lufs_norm(moving, sample_rate, torch.as_tensor(speech_lufs, device=device))[0]


def _render_static(static_audio, static_rirs, static_lufs, sample_rate, device) -> torch.Tensor:
    static = convolve_fixed_receiver(_audio(static_audio, device),
                                     torch.as_tensor(static_rirs, device=device))
    return lufs_norm(static, sample_rate, torch.as_tensor(static_lufs, device=device))[0]


def render_mixture_sources(
    speech,
    banks,
    weights,
    offsets: np.ndarray,
    lengths: np.ndarray,
    max_seg: int,
    static_audio,
    static_rirs,
    speech_lufs,
    static_lufs,
    sample_rate: int,
    mesh=None,
    weight_mask: np.ndarray | None = None,
    device=None,
):
    """All of a mixture's sources → reverberant, LUFS-normalised tracks.

    speech (S, T) and static_audio (K, T) are float or int16 PCM; banks
    (S, P, C, L) and static_rirs (K, C, L); ``offsets``/``lengths`` are the
    host tables from :func:`pad_moving_plans`, re-cut here into a
    fixed-size block plan. ``weights=None`` takes the fused crossfade
    epilogue (ramps from the segment table, ``weight_mask`` scaling each
    source's); ``weights`` (S, T) takes the gather + lerp combine.
    ``device`` defaults to the device of ``speech`` where it is a tensor,
    else to the card: numpy input with no ``device`` raises where CUDA is
    absent, and runs on the CPU only with ``device="cpu"``.

    With ``mesh`` (a ``parallel.mesh.Mesh``; ``device`` is then its first)
    the moving and the static sources are each cut into one contiguous run
    per device (the last runs one shorter, or empty, where the mesh does not
    divide them; the JAX package pads with silent sources instead), every
    run rendered on its device, and the tracks gathered on the first.
    Returns (moving (S, C, T), static (K, C, T)) tensors on that device.
    """
    if mesh is not None:
        device = mesh.primary
    elif device is None and torch.is_tensor(speech):
        device = speech.device
    else:
        device = resolve_device(device)
    s = int(speech.shape[0])
    k = int(static_audio.shape[0])
    t = int(speech.shape[-1])
    offsets = np.asarray(offsets)
    lengths = np.asarray(lengths)
    block, nb = block_plan_sizes(max_seg, t, int(offsets.shape[1]))
    plans = [
        moving_block_plan(offsets[i], lengths[i], t, block, nb)
        for i in range(s)
    ]
    block_off = np.stack([p[0] for p in plans])
    block_seg = np.stack([p[1] for p in plans])
    mask = (
        np.ones(s, np.float32) if weight_mask is None
        else np.asarray(weight_mask, np.float32)
    )

    def moving_on(dev, i):
        return _render_moving(
            speech[i], banks[i], None if weights is None else weights[i], block_off[i],
            block_seg[i], block, offsets[i], lengths[i], mask[i], speech_lufs[i],
            sample_rate, dev,
        )

    def static_on(dev, i):
        return _render_static(static_audio[i], static_rirs[i], static_lufs[i], sample_rate, dev)

    if mesh is None:
        return moving_on(device, slice(None)), static_on(device, slice(None))
    moving = gather([moving_on(d, i) for d, i in shard_slices(s, mesh)], device)
    static = gather([static_on(d, i) for d, i in shard_slices(k, mesh)], device)
    return moving, static
