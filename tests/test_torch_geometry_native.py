"""The port's pathfinder against the JAX package's native one, on the CPU.

The JAX ``NavGrid.find_path`` runs its C++ A* wherever
``sonicsim_tpu.native`` builds (sim/geometry.py:116-128), and that A*
breaks ties between equal-cost cells in ``std::priority_queue``'s order.
The port's ``find_path`` runs its own copy of that C++
(``sonicsim_tpu_torch/csrc/astar.cpp``), so on grids with obstacles its
paths are the JAX package's, waypoint for waypoint, over 300 seeded
queries on seeded grids of rectangular obstacles. Its Python A*
(``find_path_plain``) breaks ties by ``heapq``'s order: it gives other
paths on those grids, and the same ones on open rectangles.
"""

import numpy as np
import pytest

import sonicsim_tpu.native as jnative
from sonicsim_tpu.sim import geometry as jgeo
from sonicsim_tpu_torch.sim import geometry as tgeo
from sonicsim_tpu_torch.sim import native as tnative

QUERIES = 100  # per grid; three grids


def obstacle_grid(seed: int, nx: int = 60, nz: int = 50, n_rect: int = 25) -> np.ndarray:
    """A grid of ``n_rect`` seeded rectangular obstacles."""
    rng = np.random.default_rng(seed)
    occ = np.ones((nx, nz), bool)
    for _ in range(n_rect):
        i, j = rng.integers(0, nx - 2), rng.integers(0, nz - 2)
        occ[i:i + rng.integers(2, 9), j:j + rng.integers(2, 9)] = False
    return occ


def queries(nav, seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [(nav.get_random_navigable_point(rng), nav.get_random_navigable_point(rng))
            for _ in range(n)]


def same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return len(a) == len(b) and np.array_equal(np.stack(a), np.stack(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paths_are_the_jax_native_paths(seed):
    assert jnative.available()  # the JAX side runs its native A*
    occ = obstacle_grid(seed)
    tn = tgeo.NavGrid(occ.copy(), (0.5, -1.0), 0.1, 0.2)
    jn = jgeo.NavGrid(occ.copy(), (0.5, -1.0), 0.1, 0.2)
    plain_differs = 0
    for s, e in queries(tn, 100 + seed, QUERIES):
        got, want = tn.find_path(s, e), jn.find_path(s, e)
        assert same(got, want), (s, e)
        plain_differs += not same(tn.find_path_plain(s, e), want)
    assert plain_differs > 0  # the grids tell the two tie orders apart


def test_the_plain_path_agrees_on_rectangles():
    for nav in (tgeo.NavGrid.rectangle(9.3, 7.1, resolution=0.25),
                tgeo.NavGrid.rectangle(12.0, 10.0, resolution=0.1)):
        for s, e in queries(nav, 5, 50):
            assert same(nav.find_path_plain(s, e), nav.find_path(s, e))


def test_unreachable_and_off_grid():
    occ = np.ones((20, 20), bool)
    occ[10, :] = False  # a wall across the grid
    nav = tgeo.NavGrid(occ, (0.0, 0.0), 0.5)
    a, b = np.array([1.0, 0.0, 1.0]), np.array([8.0, 0.0, 8.0])
    assert nav.find_path(a, b) is None and nav.find_path_plain(a, b) is None
    assert tnative.astar_path(occ, (0, 0), (10, 3)) is None  # the goal is a wall
    cells = tnative.astar_path(occ, (0, 0), (9, 19), simplify=False)
    assert tuple(cells[0]) == (0, 0) and tuple(cells[-1]) == (9, 19) and len(cells) == 20
