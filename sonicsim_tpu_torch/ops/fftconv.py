"""Batched FFT convolution for the moving-source render, in PyTorch.

Port of the JAX package's ``ops/fftconv.py`` (native-FFT branch): linear
convolution through ``torch.fft.rfft`` at the reference's ``next_fast_len``,
and the two moving-source strategies:

* ``convolve_moving_receiver`` (dense): convolve the whole signal with every
  trajectory RIR, then crossfade per sample (SonicSim_moving.py:63-96).
* ``convolve_moving_segmented`` / ``convolve_moving_blocked``: convolve only
  the input window each segment (or fixed-size block) of the trajectory
  needs, then lay the windows on the output timeline with the ownership
  select, which applies the crossfade ramp as it reads
  (kernels.select_segments, ramp form), or the gather + lerp combine
  (kernels.crossfade_combine).

A ``vmap`` over sources in the reference is a leading batch axis here:
the moving convolutions take ``(T,)`` or ``(B, T)`` audio with ``(P, C, L)`` or
``(B, P, C, L)`` banks and return ``(C, T)`` or ``(B, C, T)``. Computation is
in float32, or float64 where the audio is float64 (the CPU reference run).
The host planners are numpy copies of the reference's, pinned to it by
tests/test_torch_planners.py.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import crossfade_combine, select_segments

# ------------------------------------------------------------ host plans ----


def next_fast_len(n: int) -> int:
    """Smallest 2^a·m ≥ n with odd part m ∈ {1, 3, 5, 9, 15}.

    The cap on the odd part comes from the TPU FFT; cuFFT does not need it.
    It stays while the port is held to the reference at the same FFT sizes."""
    if n <= 1:
        return 1
    best = None
    for m in (1, 3, 5, 9, 15):
        p2 = 1 << max(-(-n // m) - 1, 0).bit_length()
        cand = p2 * m
        if cand >= n and (best is None or cand < best):
            best = cand
    return best


def segment_plan(interp_index: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Per-segment (offsets, lengths, max_len) from the sorted, contiguous
    per-sample position indices: segment p covers the samples with
    interp_index == p."""
    idx = np.asarray(interp_index)
    n_seg = int(idx[-1]) + 1
    offsets = np.searchsorted(idx, np.arange(n_seg), side="left").astype(np.int32)
    ends = np.searchsorted(idx, np.arange(n_seg), side="right").astype(np.int32)
    lengths = ends - offsets
    return offsets, lengths, int(lengths.max())


def block_plan_sizes(max_seg: int, t: int, n_seg: int) -> tuple[int, int]:
    """(block, nb) of the blocked conv: the longest segment rounded up to an
    8192-sample quantum and capped at 16384; ``nb`` covers ``t`` plus one
    boundary block per segment, rounded up to a multiple of 16."""
    block = min(16384, -(-int(max_seg) // 8192) * 8192)
    nb = -(-int(t) // block) + int(n_seg)
    nb = -(-nb // 16) * 16
    return block, nb


def moving_block_plan(
    offsets: np.ndarray,
    lengths: np.ndarray,
    t: int,
    block: int,
    n_blocks: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Chop a segment plan into fixed-size blocks.

    Returns (block_off, block_seg), each (n_blocks,) int32: the true start
    sample of each block and the segment (RIR-pair index) it belongs to.
    Unused trailing blocks sit at off == t and own no output sample.
    """
    offs: list[int] = []
    segs: list[int] = []
    for s, (o, le) in enumerate(zip(offsets.tolist(), lengths.tolist())):
        k = 0
        while k < le:
            offs.append(o + k)
            segs.append(s)
            k += block
    if len(offs) > n_blocks:
        raise ValueError(
            f"plan needs {len(offs)} blocks > n_blocks={n_blocks}"
        )
    pad = n_blocks - len(offs)
    last_seg = max(len(offsets) - 2, 0)
    offs += [t] * pad
    segs += [last_seg] * pad
    return np.asarray(offs, np.int32), np.asarray(segs, np.int32)


# ---------------------------------------------------------------- helpers ----


def _work_dtype(*xs: torch.Tensor) -> torch.dtype:
    return (
        torch.float64 if any(x.dtype == torch.float64 for x in xs)
        else torch.float32
    )


def _table(x, bsz: int, device) -> torch.Tensor:
    """A plan table (N,) or (B, N), numpy or tensor → (B, N) int64."""
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        device=device).to(torch.int64)
    return x.expand(bsz, -1) if x.dim() == 1 else x


def _take_windows(x: torch.Tensor, off_al: torch.Tensor, win: int,
                  lead: int) -> torch.Tensor:
    """Windows x_pad[b, off_al[b, i] : off_al[b, i] + win] with x_pad = x
    left-padded by ``lead`` and right-padded by ``win``: (B, N, win)."""
    xpad = F.pad(x, (lead, win))
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return xpad.unfold(-1, win, 1)[rows, off_al]


def _batch(source_audio: torch.Tensor, rirs: torch.Tensor):
    single = source_audio.dim() == 1
    x = source_audio[None] if single else source_audio
    r = rirs[None] if rirs.dim() == 3 else rirs
    dtype = _work_dtype(x, r)
    return single, x.to(dtype), r.expand(x.shape[0], -1, -1, -1).to(dtype)


# ---------------------------------------------------------- device paths ----


def fft_convolve(signal: torch.Tensor, kernel: torch.Tensor,
                 mode: str = "full") -> torch.Tensor:
    """Linear convolution along the last axis via rfft; leading dims
    broadcast (scipy.signal.fftconvolve with axes=-1)."""
    t = signal.shape[-1]
    l = kernel.shape[-1]
    n = t + l - 1
    nfft = next_fast_len(n)
    dtype = _work_dtype(signal, kernel)
    sf = torch.fft.rfft(signal.to(dtype), nfft)
    kf = torch.fft.rfft(kernel.to(dtype), nfft)
    out = torch.fft.irfft(sf * kf, nfft)[..., :n]
    if mode == "full":
        return out
    if mode == "same":
        start = (l - 1) // 2
        return out[..., start : start + t]
    if mode == "valid":
        return out[..., l - 1 : t]
    raise ValueError(f"unknown mode {mode!r}")


def convolve_fixed_receiver(source_audio: torch.Tensor,
                            rirs: torch.Tensor) -> torch.Tensor:
    """Static reverb: (..., T) ⊛ (..., C, L) → (..., C, T), 'full'
    truncated to T (SonicSim_moving.py:47-61)."""
    t = source_audio.shape[-1]
    return fft_convolve(source_audio[..., None, :], rirs)[..., :t]


def convolve_moving_receiver(
    source_audio: torch.Tensor,
    rirs: torch.Tensor,
    interp_index: torch.Tensor,
    interp_weight: torch.Tensor,
) -> torch.Tensor:
    """Moving-source reverb, dense strategy (reference-exact semantics).

    source_audio (T,), rirs (P, C, L), interp_index (T,) in [0, P-2],
    interp_weight (T,) → (C, T)."""
    t = source_audio.shape[-1]
    conv = fft_convolve(source_audio[None, None, :], rirs)[..., :t]  # (P, C, T)
    idx = interp_index.to(torch.int64)[None, None, :].expand(1, conv.shape[1], t)
    start = conv.gather(0, idx)[0]
    end = conv.gather(0, idx + 1)[0]
    w = interp_weight.to(conv.dtype)[None, :]
    return (1.0 - w) * start + w * end


def _check_weight_args(fused: bool, interp_weight) -> None:
    if fused and interp_weight is not None:
        raise ValueError(
            "the fused epilogue rebuilds the crossfade from the segment "
            "table and takes no interp_weight; pass None, or use the "
            "unfused combine"
        )
    if not fused and interp_weight is None:
        raise ValueError("the unfused combine needs interp_weight")


def _weights(interp_weight, bsz: int, device, dtype) -> torch.Tensor:
    w = torch.as_tensor(interp_weight, device=device).to(dtype)
    return w.expand(bsz, -1) if w.dim() == 1 else w


def convolve_moving_segmented(
    source_audio: torch.Tensor,
    rirs: torch.Tensor,
    interp_weight: torch.Tensor | None,
    offsets,
    lengths,
    max_seg: int,
    fused_epilogue: bool = True,
) -> torch.Tensor:
    """Moving-source reverb, segmented strategy.

    Output samples of segment p (span [offsets[p], offsets[p]+lengths[p]))
    depend only on rir_p and rir_{p+1} convolved with the last L-1+span
    input samples, so each segment convolves its own window.

    Args:
      source_audio: (T,) or (B, T).
      rirs: (P, C, L) or (B, P, C, L).
      interp_weight: (T,) or (B, T) per-sample crossfade weights for the
        unfused combine; must be None with ``fused_epilogue`` (the ramp is
        rebuilt from the segment table, exactly linear per segment).
      offsets/lengths: (P-1,) or (B, P-1) from ``segment_plan``.
      max_seg: the longest segment.

    Returns (C, T) or (B, C, T).
    """
    _check_weight_args(fused_epilogue, interp_weight)
    single, x, r = _batch(source_audio, rirs)
    bsz, t = x.shape
    _, _, _, l = r.shape
    off = _table(offsets, bsz, x.device)
    le = _table(lengths, bsz, x.device)
    # Windows start at 128-aligned origins (off_al <= off), as in the
    # reference; ownership uses the true offsets.
    off_al = off - off % 128
    span = max_seg + 128
    win = -(-(span + l - 1) // 128) * 128
    nfft = next_fast_len(win)
    windows = _take_windows(x, off_al, win, l - 1)  # (B, N, win)
    # Overlap-save: only outputs [l-1, l-1+span) of each window's circular
    # convolution are used, and they are exact for nfft >= win.
    sf = torch.fft.rfft(windows, nfft)  # (B, N, F)
    kf = torch.fft.rfft(r, nfft)  # (B, P, C, F)
    sl = slice(l - 1, l - 1 + span)

    if fused_epilogue:
        # out = conv_start + w · conv_(end − start), where the interp weight
        # is exactly linear inside a segment: over sliced window coordinates
        # (sample u is global time off_al + u), w(u) = (u − lead)/len with
        # lead = off − off_al. K1's ramp form applies it as it selects,
        # reading both irfft outputs in place.
        conv_s = torch.fft.irfft(sf[:, :, None] * kf[:, :-1], nfft)[..., sl]
        conv_d = torch.fft.irfft(
            sf[:, :, None] * (kf[:, 1:] - kf[:, :-1]), nfft
        )[..., sl]
        shift = (off_al - off).to(x.dtype)
        scale = 1.0 / torch.clamp(le.to(x.dtype), min=1.0)
        out = select_segments(conv_s, off, off_al, t, conv_d, shift, scale)
    else:
        pair = torch.stack([kf[:, :-1], kf[:, 1:]], dim=2)  # (B, N, 2, C, F)
        conv = torch.fft.irfft(sf[:, :, None, None] * pair, nfft)[..., sl]
        w = _weights(interp_weight, bsz, x.device, x.dtype)
        out = crossfade_combine(conv.contiguous(), w, off, off_al, t)
    return out[0] if single else out


def convolve_moving_blocked(
    source_audio: torch.Tensor,
    rirs: torch.Tensor,
    interp_weight: torch.Tensor | None,
    block_off,
    block_seg,
    block: int,
    seg_offsets=None,
    seg_lengths=None,
    w_scale=None,
) -> torch.Tensor:
    """Moving-source reverb over a fixed-size block plan.

    Same math as :func:`convolve_moving_segmented`, but every window spans
    the static ``block`` instead of the longest segment.

    Args:
      source_audio: (T,) or (B, T).
      rirs: (P, C, L) or (B, P, C, L).
      interp_weight: (T,) or (B, T) for the legacy gather + lerp combine;
        None with the segment tables below.
      block_off/block_seg: (NB,) or (B, NB) from ``moving_block_plan``.
      block: block span in samples.
      seg_offsets/seg_lengths: (P-1,) or (B, P-1) segment table: enables
        the fused crossfade epilogue (ramp (t − seg_off)/seg_len).
      w_scale: scalar or (B,) ramp gain (0 for degenerate trajectories).

    Returns (C, T) or (B, C, T).
    """
    fused = seg_offsets is not None
    _check_weight_args(fused, interp_weight)
    single, x, r = _batch(source_audio, rirs)
    bsz, t = x.shape
    l = r.shape[-1]
    boff = _table(block_off, bsz, x.device)
    bseg = _table(block_seg, bsz, x.device)
    off_al = boff - boff % 128
    span = block + 128
    win = -(-(span + l - 1) // 128) * 128
    nfft = next_fast_len(win)
    windows = _take_windows(x, off_al, win, l - 1)  # (B, NB, win)
    sf = torch.fft.rfft(windows, nfft)  # (B, NB, F)
    kf = torch.fft.rfft(r, nfft)  # (B, P, C, F)
    rows = torch.arange(bsz, device=x.device)[:, None]
    ks = kf[rows, bseg]  # (B, NB, C, F)
    ke = kf[rows, bseg + 1]
    sl = slice(l - 1, l - 1 + span)

    if fused:
        so = _table(seg_offsets, bsz, x.device).gather(1, bseg)
        seg_len = _table(seg_lengths, bsz, x.device).gather(1, bseg)
        inv_len = 1.0 / torch.clamp(seg_len, min=1).to(x.dtype)
        if w_scale is not None:
            ws = torch.as_tensor(w_scale, device=x.device).to(x.dtype)
            inv_len = inv_len * ws.reshape(-1, 1)
        conv_s = torch.fft.irfft(sf[:, :, None] * ks, nfft)[..., sl]
        conv_d = torch.fft.irfft(sf[:, :, None] * (ke - ks), nfft)[..., sl]
        # Ramp over sliced window coordinates (sample u is t = off_al + u):
        # w(u) = (u + off_al − seg_off) · inv_len, applied by K1 in place.
        shift = (off_al - so).to(x.dtype)
        out = select_segments(conv_s, boff, off_al, t, conv_d, shift, inv_len)
    else:
        pair = torch.stack([ks, ke], dim=2)  # (B, NB, 2, C, F)
        conv = torch.fft.irfft(sf[:, :, None, None] * pair, nfft)[..., sl]
        w = _weights(interp_weight, bsz, x.device, x.dtype)
        out = crossfade_combine(conv.contiguous(), w, boff, off_al, t)
    return out[0] if single else out


def overlap_add_chunks(chunks: torch.Tensor, hop: int,
                       total_len: int) -> torch.Tensor:
    """Overlap-add of (N, ..., W) windows at stride ``hop`` → (..., total_len)."""
    n, *mid, w = chunks.shape
    out = chunks.new_zeros((*mid, total_len + w))
    for i in range(n):
        # The reference's dynamic_update_slice clamps the start in bounds.
        s = min(i * hop, total_len)
        out[..., s : s + w] += chunks[i]
    return out[..., :total_len]
