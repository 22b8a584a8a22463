"""Navigable-space geometry: the habitat pathfinder's replacement, in numpy.

A copy of the JAX package's ``sim/geometry.py``. A ``NavGrid`` (a rasterised
occupancy grid with world bounds) answers the queries the reference asks of
habitat-sim's navmesh: random navigable points, point snapping, shortest
paths, grid points and trajectory sampling. Every draw from the
``np.random.Generator`` comes in the reference's order, so equal seeds give
equal trajectories (tests/test_torch_gen_host.py). ``find_path`` is the
JAX package's native pathfinder, the port's own copy in C++
(``sim/native.py``, built with g++ at first use); ``find_path_plain`` is
its Python A*, which breaks ties between equal-cost cells in another order
and so agrees with it on open rectangles only
(tests/test_torch_geometry_native.py).

Coordinate convention matches habitat: x/z horizontal plane, y up.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np


@dataclass
class NavGrid:
    """Occupancy raster over the x/z plane. ``occupancy[i, j]`` is True when
    world cell (x = x0 + i*res, z = z0 + j*res) is navigable."""

    occupancy: np.ndarray  # (nx, nz) bool
    origin: tuple[float, float]  # (x0, z0) world coords of cell (0, 0)
    resolution: float  # meters per cell
    floor_height: float = 0.0

    @classmethod
    def rectangle(
        cls,
        width: float,
        depth: float,
        resolution: float = 0.1,
        floor_height: float = 0.0,
        margin: float = 0.2,
    ) -> "NavGrid":
        """Synthetic rectangular room footprint (walls inset by ``margin``)."""
        nx = max(int(round(width / resolution)), 1)
        nz = max(int(round(depth / resolution)), 1)
        occ = np.zeros((nx, nz), bool)
        m = int(round(margin / resolution))
        occ[m : nx - m or None, m : nz - m or None] = True
        return cls(occ, (0.0, 0.0), resolution, floor_height)

    # --- conversions -----------------------------------------------------
    def world_to_cell(self, x: float, z: float) -> tuple[int, int]:
        return (
            int(round((x - self.origin[0]) / self.resolution)),
            int(round((z - self.origin[1]) / self.resolution)),
        )

    def cell_to_world(self, i: int, j: int) -> tuple[float, float]:
        return (
            self.origin[0] + i * self.resolution,
            self.origin[1] + j * self.resolution,
        )

    def in_bounds(self, i: int, j: int) -> bool:
        return 0 <= i < self.occupancy.shape[0] and 0 <= j < self.occupancy.shape[1]

    def is_navigable(self, point: np.ndarray) -> bool:
        i, j = self.world_to_cell(point[0], point[2])
        return self.in_bounds(i, j) and bool(self.occupancy[i, j])

    def get_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """habitat pathfinder.get_bounds parity: (min_xyz, max_xyz)."""
        nx, nz = self.occupancy.shape
        lo = np.array([self.origin[0], self.floor_height, self.origin[1]])
        hi = np.array(
            [
                self.origin[0] + nx * self.resolution,
                self.floor_height,
                self.origin[1] + nz * self.resolution,
            ]
        )
        return lo, hi

    # --- queries ---------------------------------------------------------
    def get_random_navigable_point(self, rng: np.random.Generator) -> np.ndarray:
        idx = np.argwhere(self.occupancy)
        if len(idx) == 0:
            raise ValueError("NavGrid has no navigable cells")
        i, j = idx[rng.integers(len(idx))]
        x, z = self.cell_to_world(int(i), int(j))
        return np.array([x, self.floor_height, z])

    def snap_point(self, point: np.ndarray) -> np.ndarray:
        """Snap to the nearest navigable cell (NaNs if none, habitat parity)."""
        if self.is_navigable(point):
            return np.array([point[0], self.floor_height, point[2]])
        idx = np.argwhere(self.occupancy)
        if len(idx) == 0:
            return np.full(3, np.nan)
        world = (
            np.asarray(self.origin)[None, :] + idx.astype(np.float64) * self.resolution
        )
        d2 = (world[:, 0] - point[0]) ** 2 + (world[:, 1] - point[2]) ** 2
        i, j = idx[np.argmin(d2)]
        x, z = self.cell_to_world(int(i), int(j))
        return np.array([x, self.floor_height, z])

    def _cell_point(self, i: int, j: int) -> np.ndarray:
        x, z = self.cell_to_world(i, j)
        return np.array([x, self.floor_height, z])

    def _end_cells(self, start: np.ndarray, end: np.ndarray):
        """The snapped start and end cells, or None where either is off the
        navigable cells."""
        s = self.world_to_cell(*self.snap_point(start)[[0, 2]])
        e = self.world_to_cell(*self.snap_point(end)[[0, 2]])
        if not (self.in_bounds(*s) and self.occupancy[s]):
            return None
        if not (self.in_bounds(*e) and self.occupancy[e]):
            return None
        return s, e

    def find_path(self, start: np.ndarray, end: np.ndarray) -> list[np.ndarray] | None:
        """A* shortest path (8-connected) + string-pulling simplification;
        habitat ShortestPath.points parity (list of 3D waypoints), by the
        C++ pathfinder (``sim/native.py``), which raises where it cannot
        build."""
        from . import native

        ends = self._end_cells(start, end)
        if ends is None:
            return None
        cells = native.astar_path(self.occupancy, *ends, simplify=True)
        if cells is None:
            return None
        return [self._cell_point(int(i), int(j)) for i, j in cells]

    def find_path_plain(self, start: np.ndarray, end: np.ndarray) -> list[np.ndarray] | None:
        """:meth:`find_path` in Python (the JAX package's fallback A*): ties
        between equal-cost cells break by ``heapq``'s tuple order, not the
        C++ ``priority_queue``'s."""
        ends = self._end_cells(start, end)
        if ends is None:
            return None
        s, e = ends
        came, cost = {s: None}, {s: 0.0}
        pq = [(0.0, s)]
        moves = [
            (1, 0, 1.0), (-1, 0, 1.0), (0, 1, 1.0), (0, -1, 1.0),
            (1, 1, 1.41421356), (1, -1, 1.41421356),
            (-1, 1, 1.41421356), (-1, -1, 1.41421356),
        ]
        found = False
        while pq:
            _, cur = heapq.heappop(pq)
            if cur == e:
                found = True
                break
            for di, dj, w in moves:
                nxt = (cur[0] + di, cur[1] + dj)
                if not (self.in_bounds(*nxt) and self.occupancy[nxt]):
                    continue
                c = cost[cur] + w
                if c < cost.get(nxt, np.inf):
                    cost[nxt] = c
                    came[nxt] = cur
                    h = np.hypot(e[0] - nxt[0], e[1] - nxt[1])
                    heapq.heappush(pq, (c + h, nxt))
        if not found:
            return None
        cells = []
        cur = e
        while cur is not None:
            cells.append(cur)
            cur = came[cur]
        cells.reverse()
        return [self._cell_point(i, j) for i, j in self._simplify(cells)]

    def _line_of_sight(self, a: tuple[int, int], b: tuple[int, int]) -> bool:
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 1
        for t in np.linspace(0.0, 1.0, n + 1):
            i = int(round(a[0] + (b[0] - a[0]) * t))
            j = int(round(a[1] + (b[1] - a[1]) * t))
            if not (self.in_bounds(i, j) and self.occupancy[i, j]):
                return False
        return True

    def _simplify(self, cells: list[tuple[int, int]]) -> list[tuple[int, int]]:
        if len(cells) <= 2:
            return cells
        out = [cells[0]]
        anchor = 0
        for k in range(2, len(cells)):
            if not self._line_of_sight(cells[anchor], cells[k]):
                out.append(cells[k - 1])
                anchor = k - 1
        out.append(cells[-1])
        return out


# --- trajectory & point sampling (SonicSim_rir.py:1045-1122 parity) --------


def random_select_start_end_points(
    nav: NavGrid, rng: np.random.Generator, distance_threshold: float = 5.0
) -> tuple[np.ndarray, np.ndarray]:
    """Random start/end at least ``distance_threshold`` apart in the plane."""
    start = nav.get_random_navigable_point(rng)
    end = nav.get_random_navigable_point(rng)
    tries = 0
    while (
        np.hypot(start[0] - end[0], start[2] - end[2]) < distance_threshold
        and tries <= 100
    ):
        end = nav.get_random_navigable_point(rng)
        tries += 1
    return start, end


def sample_trajectory(
    nav: NavGrid, rng: np.random.Generator, distance_threshold: float = 5.0,
    max_tries: int = 50,
) -> list[np.ndarray]:
    """Shortest-path waypoints between random far-apart endpoints."""
    for _ in range(max_tries):
        start, end = random_select_start_end_points(nav, rng, distance_threshold)
        path = nav.find_path(start, end)
        if path is not None and len(path) >= 2:
            return path
    raise RuntimeError("no path found — is the NavGrid connected?")


def densify_path(
    path: list[np.ndarray], min_points: int
) -> list[np.ndarray]:
    """Resample a waypoint path to at least ``min_points`` by uniform
    arc-length interpolation (endpoints preserved). The moving render
    crossfades between adjacent waypoint RIRs, so more waypoints bound the
    spatial step between consecutive RIRs. Paths already at or above
    ``min_points`` are returned unchanged."""
    pts = np.asarray(path, np.float64)
    if len(pts) >= min_points or len(pts) < 2:
        return [np.asarray(p) for p in path]
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1]
    if total <= 0:
        return [np.asarray(p) for p in path]
    targets = np.linspace(0.0, total, min_points)
    out = np.empty((min_points, pts.shape[1]))
    for d in range(pts.shape[1]):
        out[:, d] = np.interp(targets, cum, pts[:, d])
    return [out[i] for i in range(min_points)]


def select_static_points(
    nav: NavGrid,
    anchor_points: list[np.ndarray],
    rng: np.random.Generator,
    distance_threshold: float = 6.0,
    num_points: int = 1,
    max_tries: int = 500,
) -> list[np.ndarray]:
    """Random navigable points 'near' ≥2 anchors (mic / noise / music
    placement)."""
    points: list[np.ndarray] = []
    tries = 0
    while len(points) < num_points and tries < max_tries:
        cand = nav.get_random_navigable_point(rng)
        close = sum(
            1
            for a in anchor_points
            if np.hypot(cand[0] - a[0], cand[2] - a[2]) < distance_threshold
            and abs(cand[1] - a[1]) < 2
        )
        if close >= min(2, len(anchor_points)):
            points.append(cand)
        tries += 1
    while len(points) < num_points:  # fallback: jitter around an anchor
        a = anchor_points[rng.integers(len(anchor_points))]
        off = rng.uniform(-distance_threshold, distance_threshold, size=2)
        snapped = nav.snap_point(np.array([a[0] + off[0], a[1], a[2] + off[1]]))
        points.append(snapped if not np.any(np.isnan(snapped)) else np.asarray(a))
    return points


def generate_xy_grid_points(
    nav: NavGrid, grid_distance: float, height: float | None = None
) -> np.ndarray:
    """Navigable grid points at a given spacing."""
    lo, hi = nav.get_bounds()
    y = nav.floor_height if height is None else height
    xs = np.arange(lo[0], hi[0] + grid_distance, grid_distance)
    zs = np.arange(lo[2], hi[2] + grid_distance, grid_distance)
    out: list[np.ndarray] = []
    for x in xs:
        for z in zs:
            snapped = nav.snap_point(np.array([x, y, z]))
            if np.any(np.isnan(snapped)):
                continue
            if any(np.linalg.norm(p - snapped) < grid_distance for p in out):
                continue
            out.append(snapped)
    return np.stack(out) if out else np.zeros((0, 3))


def interpolate_receiver_poses(
    positions: np.ndarray, rotations, video_len: int
) -> list[tuple[np.ndarray, float]]:
    """Per-video-frame (position, rotation) pose interpolation. There is no
    visual sensor in this build, so this returns the pose list."""
    from ..ops.interp import dynamic_interp_plan

    positions = np.asarray(positions, np.float64)
    rotations = np.asarray(rotations, np.float64)
    idx, w = dynamic_interp_plan(positions, video_len)
    poses = []
    for t in range(video_len):
        i = int(idx[t])
        alpha = float(w[t])
        # weight ramps 0→1 toward the NEXT waypoint
        pos = (1.0 - alpha) * positions[i] + alpha * positions[i + 1]
        rot = (1.0 - alpha) * rotations[i] + alpha * rotations[i + 1]
        poses.append((pos, rot))
    return poses
