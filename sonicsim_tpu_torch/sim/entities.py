"""Receiver/Source pose holders (SonicSim_rir.py:94-127 API parity).

The port's own copy of ``sonicsim_tpu/sim/entities.py``.

The reference passes these thin state objects into its Scene; here the
Scene API takes positions directly, but the classes are provided so code
written against the reference's signatures ports over unchanged. A
``dry_sound`` may be a wav path or an array (no device field — arrays are
host numpy until a jitted render consumes them).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Receiver:
    position: tuple[float, float, float] | np.ndarray
    rotation: float = 90.0
    sample_rate: int = 16000


@dataclass
class Source:
    position: tuple[float, float, float] | np.ndarray
    rotation: float = 0.0
    dry_sound: str | np.ndarray | None = None
