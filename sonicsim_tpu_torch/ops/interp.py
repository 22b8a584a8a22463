"""Trajectory → per-sample interpolation plan (constant-speed motion).

Host-side, seeded replacement for the reference's ``setup_dynamic_interp``
(SonicSim-SonicSet/SonicSim_moving.py:15-45): map a polyline of receiver/source
positions to, for every output audio sample, the index of the trajectory
segment it falls in and the linear crossfade weight within that segment.

This is plan-time work (tiny, data-dependent) so it stays in NumPy. It is a
copy of the JAX package's ``ops/interp.py`` (importing that would import
jax), pinned to it by tests/test_torch_planners.py; the plans feed
``sonicsim_tpu_torch.ops.fftconv``.
"""

from __future__ import annotations

import numpy as np


def dynamic_interp_plan(
    positions: np.ndarray,
    total_samples: int,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-sample (segment index, crossfade weight) for constant-speed motion.

    Args:
      positions: (P, 3) trajectory waypoints.
      total_samples: number of audio samples the motion spans.
      rng: generator used to distribute rounding error among segments (the
        reference uses np.random.choice — SonicSim_moving.py:38); pass a
        seeded Generator for reproducible plans.

    Returns:
      interp_index: (total_samples,) int32 in [0, P-2]
      interp_weight: (total_samples,) float32 in [0, 1)
    """
    positions = np.asarray(positions, dtype=np.float64)
    if positions.ndim != 2 or len(positions) < 2:
        raise ValueError("positions must be (P>=2, dim)")
    rng = rng or np.random.default_rng()

    distance = np.linalg.norm(np.diff(positions, axis=0), axis=1)
    if distance.sum() <= 0:
        # Degenerate (static) trajectory: everything in segment 0, weight 0.
        return (
            np.zeros(total_samples, np.int32),
            np.zeros(total_samples, np.float32),
        )
    speed_per_sample = distance.sum() / total_samples
    samples_per_interval = np.round(distance / speed_per_sample).astype(np.int64)

    # Distribute rounding error over randomly chosen segments.
    error = total_samples - samples_per_interval.sum()
    if error != 0:
        picks = rng.choice(len(samples_per_interval), abs(int(error)))
        np.add.at(samples_per_interval, picks, int(np.sign(error)))
    samples_per_interval = np.maximum(samples_per_interval, 0)
    # Guard: rounding + clamping can leave a residual; absorb in the largest bin.
    residual = total_samples - samples_per_interval.sum()
    if residual != 0:
        samples_per_interval[np.argmax(samples_per_interval)] += residual

    interp_index = np.repeat(
        np.arange(len(distance), dtype=np.int32), samples_per_interval
    )
    interp_weight = np.concatenate(
        [
            np.linspace(0.0, 1.0, int(num), endpoint=False)
            for num in samples_per_interval
        ]
    ).astype(np.float32)
    return interp_index, interp_weight


def interpolate_positions(
    positions: np.ndarray, interp_index: np.ndarray, interp_weight: np.ndarray
) -> np.ndarray:
    """Lerp waypoint positions at every sample (for maps/video rendering)."""
    p = np.asarray(positions, dtype=np.float64)
    start = p[interp_index]
    end = p[interp_index + 1]
    w = interp_weight[:, None]
    return (1.0 - w) * start + w * end
