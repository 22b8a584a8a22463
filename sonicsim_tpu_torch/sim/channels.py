"""Microphone/channel models: Mono, Binaural, Ambisonics, CustomArrayIR.

The port's own copy of ``sonicsim_tpu/sim/channels.py`` (numpy only);
tests/test_torch_sim_host.py pins it to the reference's output.

Parity targets: the reference's channel taxonomy and channel counts
(SonicSim-SonicSet/SonicSim_rir.py:158-166: Ambisonics (order+1)^2 ch,
Binaural 2 ch, Mono 1 ch) and the custom-array semantics of N mono renders
at ``receiver_position + mic_offset`` (SonicSim_rir.py:611-666).

Ambisonics uses AmbiX convention (ACN ordering, SN3D normalization); the
reference inherits whatever RLR-Audio-Propagation emits, so the convention
here is documented rather than bit-matched.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

CHANNEL_TYPES = ("Mono", "Binaural", "Ambisonics", "CustomArrayIR")

# Example arrays from the generation entry point (SonicSet_train.py:159-177).
LINEAR_4CH_ARRAY = [[0, 0, 0], [0, 0, 0.04], [0, 0, 0.12], [0, 0, 0.16]]
CIRCULAR_4CH_ARRAY = [[0, 0, -0.035], [0.035, 0, 0], [0, 0, 0.035], [-0.035, 0, 0]]

HEAD_RADIUS = 0.0875  # m, ear offset for the binaural model


def channel_count(
    channel_type: str, channel_order: int = 1, mic_array: list | None = None
) -> int:
    if channel_type == "Mono":
        return 1
    if channel_type == "Binaural":
        return 2
    if channel_type == "Ambisonics":
        return (channel_order + 1) ** 2
    if channel_type == "CustomArrayIR":
        if not mic_array:
            raise ValueError("CustomArrayIR requires a mic_array")
        return len(mic_array)
    raise ValueError(f"unknown channel type {channel_type!r}")


def _assoc_legendre(l: int, m: int, x: np.ndarray) -> np.ndarray:
    from scipy.special import lpmv

    return lpmv(m, l, x)


def real_sh_matrix(directions: np.ndarray, order: int) -> np.ndarray:
    """Real spherical harmonics, ACN/SN3D: (N, 3) unit dirs → (N, (order+1)^2).

    dirs are (x, y, z) with y up (habitat convention); azimuth about y.
    """
    d = np.asarray(directions, np.float64)
    az = np.arctan2(-d[:, 0], -d[:, 2])  # azimuth: 0 = -z (look dir), ccw
    el = np.arcsin(np.clip(d[:, 1], -1.0, 1.0))
    sin_el = np.sin(el)
    out = np.zeros((len(d), (order + 1) ** 2))
    for l in range(order + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt(
                (2.0 if m != 0 else 1.0)
                * math.factorial(l - am)
                / math.factorial(l + am)
            )
            leg = _assoc_legendre(l, am, sin_el) * (-1.0) ** am  # Condon-Shortley undone
            if m > 0:
                val = norm * leg * np.cos(am * az)
            elif m < 0:
                val = norm * leg * np.sin(am * az)
            else:
                val = norm * leg
            out[:, l * l + l + m] = val
    return out


@dataclass
class ChannelModel:
    """Resolved channel configuration for RIR rendering.

    ``receiver_offsets``: per-channel world offset from the receiver position
    (rotated by receiver rotation); ``directional_gain(dirs)``: per-channel
    gain for incoming direction unit vectors (N,3) → (N, C).
    """

    channel_type: str
    channel_order: int = 1
    mic_array: list | None = None

    @property
    def count(self) -> int:
        return channel_count(self.channel_type, self.channel_order, self.mic_array)

    def receiver_offsets(self, rotation_deg: float = 90.0) -> np.ndarray:
        """(C, 3) world-frame offsets of each channel's acoustic center."""
        rot = math.radians(rotation_deg)
        cos_r, sin_r = math.cos(rot), math.sin(rot)

        def rotate_y(v):
            x, y, z = v
            return np.array([cos_r * x + sin_r * z, y, -sin_r * x + cos_r * z])

        if self.channel_type == "Mono":
            return np.zeros((1, 3))
        if self.channel_type == "Binaural":
            # ears on the +/- x axis of the head frame
            return np.stack(
                [rotate_y([-HEAD_RADIUS, 0, 0]), rotate_y([HEAD_RADIUS, 0, 0])]
            )
        if self.channel_type == "Ambisonics":
            return np.zeros((self.count, 3))
        return np.stack([rotate_y(np.asarray(m, np.float64)) for m in self.mic_array])

    def directional_gain(
        self, directions: np.ndarray, rotation_deg: float = 90.0
    ) -> np.ndarray:
        """(N, 3) incoming unit dirs (receiver→source) → (N, C) gains."""
        d = np.asarray(directions, np.float64)
        if self.channel_type == "Mono" or self.channel_type == "CustomArrayIR":
            return np.ones((len(d), self.count))
        if self.channel_type == "Ambisonics":
            # The SH basis is head-locked (like the binaural ear axes):
            # rotate world dirs into the receiver frame (inverse of
            # receiver_offsets' rotate_y) before evaluating.
            rot = math.radians(rotation_deg)
            c_, s_ = math.cos(rot), math.sin(rot)
            d_local = np.stack(
                [c_ * d[:, 0] - s_ * d[:, 2], d[:, 1],
                 s_ * d[:, 0] + c_ * d[:, 2]], axis=1
            )
            return real_sh_matrix(d_local, self.channel_order)
        # Binaural: broadband head-shadow approximation — a cardioid-ish
        # gain toward each ear's outward normal.
        offsets = self.receiver_offsets(rotation_deg)
        normals = offsets / np.maximum(
            np.linalg.norm(offsets, axis=1, keepdims=True), 1e-9
        )
        cos_inc = d @ normals.T  # (N, 2)
        return 0.6 + 0.4 * cos_inc
