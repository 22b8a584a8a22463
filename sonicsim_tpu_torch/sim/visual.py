"""Visual-sensor data path: per-frame pose interpolation → RGB(+depth).

Port of ``sonicsim_tpu.sim.visual``: host code in both packages, built on
the port's ``sim.geometry`` and ``sim.maps``.

Parity targets: interpolate_rgb_images (SonicSim_moving.py:146-189 — lerp
receiver position/rotation at every video frame, render one RGB per pose)
and render_image / render_envmap (SonicSim_rir.py:472-514 — current-pose
RGB+depth, and a 4-view panorama at rotation offsets [0, 270, 180, 90]).

The renderer is injectable: ``habitat_render_fn`` adapts a live habitat
Simulator (color_sensor/depth_sensor observations); ``topdown_render_fn``
is a hermetic NavGrid rasterizer so the visual path runs — and is tested —
without habitat. Frame math is plain NumPy either way; nothing here touches
the device.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

from .geometry import NavGrid, interpolate_receiver_poses
from .maps import points_to_pixels, topdown_map

# A frame renderer maps (position (3,), rotation_deg) -> (rgb, depth) where
# rgb is (H, W, 3+) uint8 and depth is (H, W) float or None.
RenderFn = Callable[[np.ndarray, float], tuple[np.ndarray, np.ndarray | None]]


def interpolate_rgb_images(
    render_fn: RenderFn,
    receiver_positions: np.ndarray,
    receiver_rotations,
    video_len: int,
) -> list[np.ndarray]:
    """One RGB frame per interpolated receiver pose
    (interpolate_rgb_images, SonicSim_moving.py:146-189)."""
    frames = []
    for pos, rot in interpolate_receiver_poses(
        receiver_positions, receiver_rotations, video_len
    ):
        rgb, _ = render_fn(np.asarray(pos), float(rot))
        frames.append(np.asarray(rgb)[..., :3])
    return frames


def render_envmap(
    render_fn: RenderFn,
    receiver_position: np.ndarray,
    receiver_rotation: float,
    angles: tuple[int, ...] = (0, 270, 180, 90),
) -> tuple[np.ndarray, np.ndarray | None]:
    """4-view panorama at rotation offsets (render_envmap,
    SonicSim_rir.py:486-514): concatenate per-angle RGB (and depth when the
    renderer provides it) along width."""
    rgbs, depths = [], []
    for off in angles:
        rgb, depth = render_fn(
            np.asarray(receiver_position), float(receiver_rotation + off)
        )
        rgbs.append(np.asarray(rgb))
        depths.append(depth)
    envmap_rgb = np.concatenate(rgbs, axis=1)
    envmap_depth = (
        np.concatenate([np.asarray(d) for d in depths], axis=1)
        if all(d is not None for d in depths)
        else None
    )
    return envmap_rgb, envmap_depth


def topdown_render_fn(
    nav: NavGrid,
    meters_per_pixel: float = 0.05,
    marker_radius: int = 2,
    heading_len: int = 5,
) -> RenderFn:
    """Hermetic renderer: top-down occupancy raster with the receiver drawn
    as a red marker + green heading ray (the role of habitat's color_sensor
    for trace/debug video when no 3D renderer is available)."""
    base = topdown_map(nav, meters_per_pixel)  # (H, W) bool-ish

    def render(position: np.ndarray, rotation_deg: float):
        h, w = base.shape
        rgb = np.repeat((base[..., None] > 0).astype(np.uint8) * 220, 3, -1)
        px = points_to_pixels(position[None, :], nav, meters_per_pixel)[0]
        r, c = int(px[1]), int(px[0])
        rr = slice(max(r - marker_radius, 0), min(r + marker_radius + 1, h))
        cc = slice(max(c - marker_radius, 0), min(c + marker_radius + 1, w))
        rgb[rr, cc] = (255, 40, 40)
        theta = math.radians(rotation_deg)
        # Forward for rotation θ is world (-sin θ, -cos θ) in (x, z)
        # under rotate_y / habitat's quat-about-+y convention (head
        # frame forward = -z), so BOTH pixel deltas are negative.
        for step in range(1, heading_len + 1):
            hr = r - int(round(step * math.cos(theta)))
            hc = c - int(round(step * math.sin(theta)))
            if 0 <= hr < h and 0 <= hc < w:
                rgb[hr, hc] = (40, 220, 40)
        depth = np.zeros(base.shape, np.float32)
        return rgb, depth

    return render


def habitat_render_fn(sim, agent_id: int = 0, habitat=None) -> RenderFn:
    """Adapt a live habitat Simulator with color/depth sensors to a
    RenderFn (render_image, SonicSim_rir.py:472-484): re-pose the agent,
    read one observation."""
    if habitat is None:
        import habitat_sim as habitat

    def render(position: np.ndarray, rotation_deg: float):
        agent = sim.get_agent(agent_id)
        state = agent.get_state()
        state.position = np.asarray(position, np.float32)
        state.rotation = habitat.utils.common.quat_from_angle_axis(
            math.radians(rotation_deg), np.array([0.0, 1.0, 0.0])
        )
        state.sensor_states = {}
        agent.set_state(state, True)
        obs = sim.get_sensor_observations()
        return obs["color_sensor"], obs.get("depth_sensor")

    return render
