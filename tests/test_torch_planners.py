"""The port's host planners against the JAX package's.

Tolerance: none. The planners are numpy on both sides, fed the same inputs
and the same seeded generators, so every output must be equal.
"""

import numpy as np
import pytest

from sonicsim_tpu.ops import fftconv as jfft
from sonicsim_tpu.ops import interp as jinterp
from sonicsim_tpu_torch.ops import fftconv as tfft
from sonicsim_tpu_torch.ops import interp as tinterp
from torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize(
    "n", [0, 1, 2, 7, 100, 16001, 48896, 65219, 486000, 975999, 10_000_001]
)
def test_next_fast_len(n):
    assert tfft.next_fast_len(n) == jfft.next_fast_len(n)


@pytest.mark.parametrize("p,t,seed", [(2, 1000, 0), (6, 4000, 1), (40, 37000, 2)])
def test_dynamic_interp_plan_and_positions(p, t, seed):
    positions = np.cumsum(
        np.random.default_rng(seed).uniform(0.2, 0.6, (p, 3)), axis=0
    )
    ji, jw = jinterp.dynamic_interp_plan(
        positions, t, rng=np.random.default_rng(seed)
    )
    ti, tw = tinterp.dynamic_interp_plan(
        positions, t, rng=np.random.default_rng(seed)
    )
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)
    assert ti.dtype == ji.dtype and tw.dtype == jw.dtype
    np.testing.assert_array_equal(
        tinterp.interpolate_positions(positions, ti, tw),
        jinterp.interpolate_positions(positions, ji, jw),
    )


def test_dynamic_interp_plan_degenerate_and_invalid():
    still = np.zeros((4, 3))
    for a, b in zip(tinterp.dynamic_interp_plan(still, 500),
                    jinterp.dynamic_interp_plan(still, 500)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tinterp.dynamic_interp_plan(np.zeros((1, 3)), 10)


@pytest.mark.parametrize("p,t", [(5, 4000), (9, 40000)])
def test_segment_and_block_plans(rng, p, t):
    positions = np.cumsum(rng.uniform(0.3, 1.0, (p, 3)), axis=0)
    idx, _ = jinterp.dynamic_interp_plan(positions, t, rng=rng)
    seg_t = tfft.segment_plan(idx)
    seg_j = jfft.segment_plan(idx)
    for a, b in zip(seg_t[:2], seg_j[:2]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert seg_t[2] == seg_j[2]

    off, le, max_seg = seg_j
    for ms in (max_seg, 8192, 40000):
        assert tfft.block_plan_sizes(ms, t, len(off)) == jfft.block_plan_sizes(
            ms, t, len(off)
        )
    for block in (300, 1024):
        nb = -(-t // block) + len(off) + 3
        for a, b in zip(tfft.moving_block_plan(off, le, t, block, nb),
                        jfft.moving_block_plan(off, le, t, block, nb)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    with pytest.raises(ValueError, match="n_blocks"):
        tfft.moving_block_plan(off, le, t, 300, 2)
