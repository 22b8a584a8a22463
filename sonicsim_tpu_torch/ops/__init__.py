from .fftconv import (
    block_plan_sizes,
    convolve_fixed_receiver,
    convolve_moving_blocked,
    convolve_moving_receiver,
    convolve_moving_segmented,
    fft_convolve,
    moving_block_plan,
    next_fast_len,
    overlap_add_chunks,
    segment_plan,
)
from .interp import dynamic_interp_plan, interpolate_positions
from .kernels import (
    crossfade_combine,
    crossfade_combine_ref,
    select_segments,
    select_segments_ref,
)
from .loudness import (
    biquad,
    integrated_loudness,
    k_weight,
    k_weighting_coeffs,
    loudness_normalize,
    lufs_norm,
)

__all__ = [
    "biquad",
    "block_plan_sizes",
    "convolve_fixed_receiver",
    "convolve_moving_blocked",
    "convolve_moving_receiver",
    "convolve_moving_segmented",
    "crossfade_combine",
    "crossfade_combine_ref",
    "dynamic_interp_plan",
    "fft_convolve",
    "integrated_loudness",
    "interpolate_positions",
    "k_weight",
    "k_weighting_coeffs",
    "loudness_normalize",
    "lufs_norm",
    "moving_block_plan",
    "next_fast_len",
    "overlap_add_chunks",
    "segment_plan",
    "select_segments",
    "select_segments_ref",
]
