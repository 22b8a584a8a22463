"""Per-room navigable grid-point cache (a copy of the JAX package's
``sim/grid_cache.py``): navigable grid points are computed once per room and
grid spacing and kept under ``<root>/grid_<spacing>/grid_<room>.npy``."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .geometry import NavGrid, generate_xy_grid_points


def grid_cache_path(root: str | Path, room: str, grid_distance: float) -> Path:
    return Path(root) / f"grid_{grid_distance}" / f"grid_{room}.npy"


def save_xy_grid_points(
    nav: NavGrid, room: str, grid_distance: float, root: str | Path
) -> np.ndarray:
    points = generate_xy_grid_points(nav, grid_distance)
    path = grid_cache_path(root, room, grid_distance)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, points)
    return points


def load_room_grid(
    room: str,
    grid_distance: float,
    root: str | Path,
    nav: NavGrid | None = None,
) -> np.ndarray:
    """Load cached grid points, computing them when absent and a NavGrid is
    given."""
    path = grid_cache_path(root, room, grid_distance)
    if path.exists():
        return np.load(path)
    if nav is None:
        raise FileNotFoundError(
            f"{path} missing and no NavGrid provided to compute it"
        )
    return save_xy_grid_points(nav, room, grid_distance, root)
