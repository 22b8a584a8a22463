"""The port's FFT convolutions against the JAX package's, on the CPU.

Tolerance: both sides run float32 FFTs at the same nfft (the port keeps
the reference's ``next_fast_len``) but through different FFT libraries
(torch's and XLA's), so outputs agree to float32 FFT rounding.
Every case is held to atol = 1e-5 · max|ref| (relative to the signal's
scale; the measured gap is about 1e-6 of it) and rtol 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicsim_tpu.ops import fftconv as J
from sonicsim_tpu.ops.interp import dynamic_interp_plan
from sonicsim_tpu_torch.ops import fftconv as T
from torch_threads import one_intra_op_thread  # noqa: F401

REL = 1e-5


def assert_close(ours, ref):
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=REL * np.abs(ref).max())


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _case(rng, t=5000, p=8, c=3, l=256):
    audio = rng.standard_normal(t).astype(np.float32)
    rirs = (rng.standard_normal((p, c, l)) * np.exp(-np.linspace(0, 6, l))).astype(
        np.float32
    )
    positions = np.cumsum(rng.uniform(0.5, 1.5, size=(p, 3)), axis=0)
    idx, w = dynamic_interp_plan(positions, t, rng=rng)
    return audio, rirs, idx, w


@pytest.mark.parametrize(
    "xs,ks,mode",
    [((1000,), (137,), "full"), ((512,), (64,), "same"), ((512,), (64,), "valid"),
     ((3, 1, 400), (1, 2, 93), "full")],
)
def test_fft_convolve(rng, xs, ks, mode):
    x = rng.standard_normal(xs).astype(np.float32)
    k = rng.standard_normal(ks).astype(np.float32)
    assert_close(T.fft_convolve(_t(x), _t(k), mode),
                 J.fft_convolve(jnp.asarray(x), jnp.asarray(k), mode))


def test_fft_convolve_bad_mode():
    with pytest.raises(ValueError, match="mode"):
        T.fft_convolve(torch.zeros(8), torch.zeros(3), "circular")


def test_convolve_fixed_receiver_batched(rng):
    """The static reverb, alone and batched over sources (the reference
    vmaps it in the mixture step)."""
    audio = rng.standard_normal((2, 2000)).astype(np.float32)
    rirs = rng.standard_normal((2, 4, 300)).astype(np.float32)
    batched = T.convolve_fixed_receiver(_t(audio), _t(rirs))
    for i in range(2):
        ref = J.convolve_fixed_receiver(jnp.asarray(audio[i]), jnp.asarray(rirs[i]))
        assert_close(T.convolve_fixed_receiver(_t(audio[i]), _t(rirs[i])), ref)
        assert_close(batched[i], ref)


def test_convolve_moving_dense(rng):
    audio, rirs, idx, w = _case(rng, t=4000, p=6, c=2, l=200)
    assert_close(
        T.convolve_moving_receiver(_t(audio), _t(rirs), _t(idx), _t(w)),
        J.convolve_moving_receiver(jnp.asarray(audio), jnp.asarray(rirs),
                                   jnp.asarray(idx), jnp.asarray(w)),
    )


@pytest.mark.parametrize("fused", [True, False])
def test_convolve_moving_segmented(rng, fused):
    audio, rirs, idx, w = _case(rng)
    off, le, max_seg = J.segment_plan(idx)
    ref = J.convolve_moving_segmented(
        jnp.asarray(audio), jnp.asarray(rirs), jnp.asarray(w),
        jnp.asarray(off), jnp.asarray(le), max_seg, fused_epilogue=fused,
    )
    ours = T.convolve_moving_segmented(
        _t(audio), _t(rirs), None if fused else _t(w), off, le, max_seg,
        fused_epilogue=fused,
    )
    assert_close(ours, ref)


@pytest.mark.parametrize("fused", [True, False])
def test_convolve_moving_segmented_batched(rng, fused):
    """Two sources through one call (the headline's vmap) match two
    reference calls; shared plan, per-source audio and banks."""
    cases = [_case(np.random.default_rng(s), t=3000, p=5, c=2, l=128)
             for s in (1, 2)]
    idx, w = cases[0][2], cases[0][3]
    off, le, max_seg = J.segment_plan(idx)
    audio = np.stack([c[0] for c in cases])
    rirs = np.stack([c[1] for c in cases])
    ours = T.convolve_moving_segmented(
        _t(audio), _t(rirs), None if fused else _t(w), off, le, max_seg,
        fused_epilogue=fused,
    )
    for i in range(2):
        ref = J.convolve_moving_segmented(
            jnp.asarray(audio[i]), jnp.asarray(rirs[i]), jnp.asarray(w),
            jnp.asarray(off), jnp.asarray(le), max_seg, fused_epilogue=fused,
        )
        assert_close(ours[i], ref)


def test_fused_epilogue_takes_no_weights(rng):
    audio, rirs, idx, w = _case(rng, t=1000, p=3, c=1, l=64)
    off, le, max_seg = J.segment_plan(idx)
    with pytest.raises(ValueError, match="interp_weight"):
        T.convolve_moving_segmented(_t(audio), _t(rirs), _t(w), off, le, max_seg)
    with pytest.raises(ValueError, match="interp_weight"):
        T.convolve_moving_segmented(_t(audio), _t(rirs), None, off, le, max_seg,
                                    fused_epilogue=False)
    bo, bs = J.moving_block_plan(off, le, 1000, 512, 8)
    with pytest.raises(ValueError, match="interp_weight"):
        T.convolve_moving_blocked(_t(audio), _t(rirs), _t(w), bo, bs, 512,
                                  seg_offsets=off, seg_lengths=le)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("giant", [False, True])
def test_convolve_moving_blocked(rng, fused, giant):
    """Blocked conv, multi-block segments; ``giant``: one segment owns
    almost the whole signal (with arbitrary weights on the legacy path)."""
    if giant:
        t, p, c, l = 8000, 3, 2, 128
        audio = rng.standard_normal(t).astype(np.float32)
        rirs = rng.standard_normal((p, c, l)).astype(np.float32) * 0.1
        idx = np.zeros(t, np.int32)
        idx[-100:] = 1
        off, le, _ = J.segment_plan(idx)
        w = rng.uniform(0, 1, t).astype(np.float32)  # legacy path only
        block = 1024
    else:
        audio, rirs, idx, w = _case(rng)
        t = len(idx)
        off, le, _ = J.segment_plan(idx)
        block = 512
    nb = -(-t // block) + len(off)
    bo, bs = J.moving_block_plan(off, le, t, block, nb)
    seg = dict(seg_offsets=off, seg_lengths=le) if fused else {}
    ref = J.convolve_moving_blocked(
        jnp.asarray(audio), jnp.asarray(rirs), None if fused else jnp.asarray(w),
        jnp.asarray(bo), jnp.asarray(bs), block,
        **{k: jnp.asarray(v) for k, v in seg.items()},
    )
    ours = T.convolve_moving_blocked(
        _t(audio), _t(rirs), None if fused else _t(w), bo, bs, block, **seg
    )
    assert_close(ours, ref)


def test_convolve_moving_blocked_batched_plans_and_scale(rng):
    """Per-source block plans and ramp gains in one batched call (the
    mixture step's layout) match per-source reference calls."""
    t, block = 4000, 512
    refs, inputs = [], []
    for s, scale in ((3, 1.0), (4, 0.0)):
        audio, rirs, idx, _ = _case(np.random.default_rng(s), t=t, p=5, c=2, l=128)
        off, le, _ = J.segment_plan(idx)
        bo, bs = J.moving_block_plan(off, le, t, block, 16)
        inputs.append((audio, rirs, off, le, bo, bs, scale))
        refs.append(J.convolve_moving_blocked(
            jnp.asarray(audio), jnp.asarray(rirs), None, jnp.asarray(bo),
            jnp.asarray(bs), block, seg_offsets=jnp.asarray(off),
            seg_lengths=jnp.asarray(le), w_scale=jnp.float32(scale),
        ))
    col = [np.stack(c) for c in zip(*inputs)]
    ours = T.convolve_moving_blocked(
        _t(col[0]), _t(col[1]), None, col[4], col[5], block,
        seg_offsets=col[2], seg_lengths=col[3], w_scale=_t(col[6]),
    )
    for i in range(2):
        assert_close(ours[i], refs[i])


def test_overlap_add_chunks(rng):
    chunks = rng.standard_normal((5, 2, 64)).astype(np.float32)
    for hop, total in ((32, 200), (48, 100)):  # the second clamps a start
        assert_close(T.overlap_add_chunks(_t(chunks), hop, total),
                     J.overlap_add_chunks(jnp.asarray(chunks), hop, total))
