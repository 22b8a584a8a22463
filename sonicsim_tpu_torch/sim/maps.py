"""Top-down maps and the trajectory trace of a mixture (a copy of the JAX
package's ``sim/maps.py`` without the animated GIF): a navigability raster
over a NavGrid, with the speakers' paths and the mic, noise and music
markers drawn on it."""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from .geometry import NavGrid

logger = logging.getLogger(__name__)


def topdown_map(nav: NavGrid, meters_per_pixel: float = 0.05) -> np.ndarray:
    """Boolean navigability raster at the requested resolution (True=free)."""
    lo, hi = nav.get_bounds()
    nx = max(int((hi[0] - lo[0]) / meters_per_pixel), 1)
    nz = max(int((hi[2] - lo[2]) / meters_per_pixel), 1)
    xs = lo[0] + (np.arange(nx) + 0.5) * meters_per_pixel
    zs = lo[2] + (np.arange(nz) + 0.5) * meters_per_pixel
    out = np.zeros((nz, nx), bool)
    for j, z in enumerate(zs):
        for i, x in enumerate(xs):
            out[j, i] = nav.is_navigable(np.array([x, nav.floor_height, z]))
    return out


def points_to_pixels(
    points: np.ndarray, nav: NavGrid, meters_per_pixel: float = 0.05
) -> np.ndarray:
    """(N, 3) world points → (N, 2) pixel (col, row) on the top-down map."""
    lo, _ = nav.get_bounds()
    pts = np.atleast_2d(np.asarray(points))
    px = (pts[:, 0] - lo[0]) / meters_per_pixel
    pz = (pts[:, 2] - lo[2]) / meters_per_pixel
    return np.stack([px, pz], axis=1)


def topdown_map_cached(nav: NavGrid, meters_per_pixel: float) -> np.ndarray:
    """Per-scene memo of the navigability raster: the Python sweep is the
    same for every mixture of a scene. Stored on the NavGrid instance so the
    memo lives and dies with the scene."""
    cache = getattr(nav, "_topdown_cache", None)
    if cache is None:
        cache = {}
        nav._topdown_cache = cache
    grid = cache.get(meters_per_pixel)
    if grid is None:
        grid = topdown_map(nav, meters_per_pixel)
        cache[meters_per_pixel] = grid
    return grid


def save_trace_image(
    filename: str | Path,
    nav: NavGrid,
    trajectories: list[np.ndarray] | None = None,
    mic_points: np.ndarray | None = None,
    static_points: np.ndarray | None = None,
    meters_per_pixel: float = 0.05,
    scale: int = 4,
) -> str | None:
    """Render the navigable area with speaker trajectories, mic and
    noise/music markers to a PNG. Drawn with PIL, else with matplotlib.
    Returns which one drew it (``"PIL"`` or ``"matplotlib"``); where neither
    is importable, logs a warning, writes nothing and returns None."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            logger.warning("neither PIL nor matplotlib is importable: %s "
                           "left out", filename)
            return None
        _save_trace_image_mpl(
            filename, nav, trajectories, mic_points, static_points,
            meters_per_pixel,
        )
        return "matplotlib"
    img = _draw_trace_pil(
        nav, trajectories, mic_points, static_points, meters_per_pixel, scale
    )
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    img.save(filename)
    return "PIL"


_TRACE_COLORS = [(214, 39, 40), (31, 119, 180), (44, 160, 44),
                 (255, 127, 14)]


def _draw_trace_pil(
    nav, trajectories, mic_points, static_points, meters_per_pixel, scale
):
    """Navigable raster + full paths + mic/static markers, as a PIL image."""
    from PIL import Image, ImageDraw

    grid = topdown_map_cached(nav, meters_per_pixel)
    h, w = grid.shape
    base = np.where(grid[..., None], np.uint8(235), np.uint8(64)).repeat(
        3, axis=2
    )
    img = Image.fromarray(base[::-1]).resize(  # origin="lower" parity
        (w * scale, h * scale), Image.NEAREST
    )
    dr = ImageDraw.Draw(img)

    def to_xy(points):
        pix = points_to_pixels(np.atleast_2d(points), nav, meters_per_pixel)
        # Cell centres of the vertically flipped raster: row p[1] of an
        # h-row grid lands at flipped row h-1-p[1]; +0.5 centres within
        # the scale-pixel cell.
        return [
            ((float(p[0]) + 0.5) * scale,
             (float(h - 1 - p[1]) + 0.5) * scale)
            for p in pix
        ]

    for k, traj in enumerate(trajectories or []):
        xy = to_xy(np.asarray(traj))
        c = _TRACE_COLORS[k % len(_TRACE_COLORS)]
        if len(xy) > 1:
            dr.line(xy, fill=c, width=2)
        for x, y in xy:
            dr.ellipse([x - 3, y - 3, x + 3, y + 3], fill=c)
    if mic_points is not None:
        for x, y in to_xy(mic_points):
            dr.regular_polygon((x, y, 10), 5, rotation=0,
                               fill=(255, 215, 0), outline=(0, 0, 0))
    if static_points is not None:
        for x, y in to_xy(static_points):
            dr.rectangle([x - 5, y - 5, x + 5, y + 5], fill=(255, 0, 255),
                         outline=(0, 0, 0))
    return img


def _save_trace_image_mpl(
    filename: str | Path,
    nav: NavGrid,
    trajectories: list[np.ndarray] | None = None,
    mic_points: np.ndarray | None = None,
    static_points: np.ndarray | None = None,
    meters_per_pixel: float = 0.05,
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grid = topdown_map_cached(nav, meters_per_pixel)
    fig, ax = plt.subplots(figsize=(8, 8 * grid.shape[0] / max(grid.shape[1], 1)))
    ax.imshow(grid, cmap="gray", origin="lower", interpolation="nearest")
    colors = ["tab:red", "tab:blue", "tab:green", "tab:orange"]
    for k, traj in enumerate(trajectories or []):
        pix = points_to_pixels(np.asarray(traj), nav, meters_per_pixel)
        ax.plot(pix[:, 0], pix[:, 1], "-o", ms=3, color=colors[k % len(colors)],
                label=f"speaker {k + 1}")
    if mic_points is not None:
        pix = points_to_pixels(mic_points, nav, meters_per_pixel)
        ax.scatter(pix[:, 0], pix[:, 1], marker="*", s=200, c="gold", label="mic",
                   edgecolors="k", zorder=5)
    if static_points is not None:
        pix = points_to_pixels(static_points, nav, meters_per_pixel)
        ax.scatter(pix[:, 0], pix[:, 1], marker="s", s=80, c="magenta",
                   label="noise/music", edgecolors="k", zorder=5)
    ax.legend(loc="upper right", fontsize=8)
    ax.set_axis_off()
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(filename, bbox_inches="tight", dpi=120)
    plt.close(fig)
