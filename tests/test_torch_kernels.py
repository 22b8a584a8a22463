"""The Hopper kernels' plain versions against the JAX package's kernels,
and the kernels against their plain versions on the card.

Tolerances: the ownership select (K1) only copies values, so it must be
bit-exact against the Pallas kernel (interpret mode) and the XLA gather.
The combine (K2) rounds (1 − w)·start + w·end in float32 in the same order
on both sides; it is held to 1e-6 absolute on O(1) inputs, which allows one
rounding difference should a compiler contract a multiply-add.

The card's tests import neither jax nor the JAX package (the GPU host has
neither) and use no conftest fixture, so they run there alone:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from sonicsim_tpu_torch.ops import dynamic_interp_plan, kernels, segment_plan
from torch_threads import one_intra_op_thread  # noqa: F401

K2_ATOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _plan(rng, t, p, short):
    """Segment tables for t samples over p waypoints; ``short`` adds a
    blocked-style tail of tiny segments and padding entries at off == t."""
    positions = np.cumsum(rng.uniform(0.3, 0.6, (p, 3)), axis=0)
    idx, w = dynamic_interp_plan(positions, t, rng=rng)
    off, le, max_seg = segment_plan(idx)
    if short:
        off = np.concatenate([off, np.full(3, t, np.int32)])
        le = np.concatenate([le, np.zeros(3, np.int32)])
    return off.astype(np.int32), (off - off % 128).astype(np.int32), w, max_seg + 128


# (t, waypoints, short): segments >= BLOCK (8192) go to the Pallas kernel;
# shorter ones, with padding entries, to the XLA gather.
CASES = {"long": (40000, 4, False), "short": (40000, 9, True)}


def _k1_inputs(rng, case):
    t, p, short = CASES[case]
    off, off_al, _, span = _plan(rng, t, p, short)
    combined = rng.standard_normal((len(off), 2, span)).astype(np.float32)
    return combined, off, off_al, t


def _jax():
    import jax.numpy as jnp

    from sonicsim_tpu.ops import fftconv as jfft
    from sonicsim_tpu.ops import pallas_kernels as jpk

    return jnp, jfft, jpk


@pytest.mark.parametrize("case", ["long", "short"])
def test_select_segments_plain_matches_jax(rng, case):
    jnp, jfft, jpk = _jax()
    combined, off, off_al, t = _k1_inputs(rng, case)
    ours = kernels.select_segments_ref(
        torch.from_numpy(combined)[None], torch.from_numpy(off)[None],
        torch.from_numpy(off_al)[None], t,
    )[0].numpy()
    args = (jnp.asarray(combined), jnp.asarray(off), jnp.asarray(off_al), t)
    np.testing.assert_array_equal(ours, np.asarray(jfft._fused_lerp_select(*args)))
    if case == "long":
        assert int(np.diff(np.append(off, t)).min()) >= jpk.BLOCK  # 8192
        np.testing.assert_array_equal(
            ours, np.asarray(jpk.select_segments(*args, interpret=True))
        )


def _k2_inputs(rng, case):
    t, p, short = CASES[case]
    off, off_al, w, span = _plan(rng, t, p, short)
    conv = rng.standard_normal((len(off), 2, 2, span)).astype(np.float32)
    return conv, w, off, off_al, t


@pytest.mark.parametrize("case", ["long", "short"])
def test_crossfade_combine_plain_matches_jax(rng, case):
    jnp, jfft, jpk = _jax()
    conv, w, off, off_al, t = _k2_inputs(rng, case)
    ours = kernels.crossfade_combine_ref(
        torch.from_numpy(conv)[None], torch.from_numpy(w)[None],
        torch.from_numpy(off)[None], torch.from_numpy(off_al)[None], t,
    )[0].numpy()
    ref = jfft._ownership_combine(
        jnp.asarray(conv), jnp.asarray(off), jnp.asarray(off_al),
        jnp.asarray(w), conv.shape[-1], t,
    )
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=K2_ATOL)
    if case == "long":
        pallas = jpk.crossfade_combine(
            jnp.asarray(conv), jnp.asarray(off), jnp.asarray(off_al),
            jnp.asarray(w), t, interpret=True,
        )
        np.testing.assert_allclose(ours, np.asarray(pallas), rtol=0, atol=K2_ATOL)


def _batch2(x, y):
    """Two batch rows of one case: the operand and its negation."""
    x = torch.from_numpy(x)
    return torch.stack([x, -x]), torch.from_numpy(y).expand(2, *y.shape)


def test_wrappers_take_plain_path_on_cpu(rng):
    """On CPU tensors the wrappers are the plain versions, row by row of
    the batch, and no kernel launch is counted."""
    before = dict(kernels.LAUNCHES)
    combined, off, off_al, t = _k1_inputs(rng, "short")
    c, o = _batch2(combined, off)
    a = torch.from_numpy(off_al).expand(2, -1)
    out = kernels.select_segments(c, o, a, t)
    torch.testing.assert_close(out, kernels.select_segments_ref(c, o, a, t),
                               rtol=0, atol=0)
    torch.testing.assert_close(out[1], -out[0], rtol=0, atol=0)

    conv, w, off, off_al, t = _k2_inputs(rng, "short")
    cv, o = _batch2(conv, off)
    a = torch.from_numpy(off_al).expand(2, -1)
    wt = torch.from_numpy(w).expand(2, -1)
    out = kernels.crossfade_combine(cv, wt, o, a, t)
    torch.testing.assert_close(
        out, kernels.crossfade_combine_ref(cv, wt, o, a, t), rtol=0, atol=0
    )
    torch.testing.assert_close(out[1], -out[0], rtol=0, atol=0)
    assert kernels.LAUNCHES == before


def test_wrappers_reject_bad_arguments():
    i32 = dict(dtype=torch.int32)
    c = torch.zeros(1, 3, 2, 256)
    with pytest.raises(ValueError, match="conv_s must be"):
        kernels.select_segments(c[0], torch.zeros(1, 3, **i32),
                                torch.zeros(1, 3, **i32), 100)
    with pytest.raises(ValueError, match="off_true must be"):
        kernels.select_segments(c, torch.zeros(1, 4, **i32),
                                torch.zeros(1, 4, **i32), 100)
    with pytest.raises(TypeError, match="int32 or int64"):
        kernels.select_segments(c, torch.zeros(1, 3), torch.zeros(1, 3), 100)
    tables = (torch.zeros(1, 3, **i32), torch.zeros(1, 3, **i32))
    with pytest.raises(ValueError, match="conv must be"):
        kernels.crossfade_combine(torch.zeros(1, 3, 3, 2, 256),
                                  torch.zeros(1, 100), *tables, 100)
    with pytest.raises(ValueError, match="w must be"):
        kernels.crossfade_combine(torch.zeros(1, 3, 2, 2, 256),
                                  torch.zeros(1, 99), *tables, 100)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long", "short"])
def test_select_segments_kernel_matches_plain(cuda_device, case):
    rng = np.random.default_rng(0)
    combined, off, off_al, t = _k1_inputs(rng, case)
    c = torch.from_numpy(np.stack([combined, combined[::-1].copy()])).to(cuda_device)
    o = torch.from_numpy(off).to(cuda_device).expand(2, -1)
    a = torch.from_numpy(off_al).to(cuda_device).expand(2, -1)
    n0 = kernels.LAUNCHES["select_segments"]
    out = kernels.select_segments(c, o, a, t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["select_segments"] == n0 + 1
    ref = kernels.select_segments_ref(c, o, a, t)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long", "short"])
def test_crossfade_combine_kernel_matches_plain(cuda_device, case):
    rng = np.random.default_rng(0)
    conv, w, off, off_al, t = _k2_inputs(rng, case)
    cv = torch.from_numpy(conv).to(cuda_device)[None]
    wt = torch.from_numpy(w).to(cuda_device)[None]
    o = torch.from_numpy(off).to(cuda_device)[None]
    a = torch.from_numpy(off_al).to(cuda_device)[None]
    n0 = kernels.LAUNCHES["crossfade_combine"]
    out = kernels.crossfade_combine(cv, wt, o, a, t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crossfade_combine"] == n0 + 1
    ref = kernels.crossfade_combine_ref(cv, wt, o, a, t)
    torch.testing.assert_close(out, ref, rtol=0, atol=K2_ATOL)
