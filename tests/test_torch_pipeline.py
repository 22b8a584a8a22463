"""The port's mixture step against the JAX package's, on the CPU.

Tolerances: plans and padding are numpy on both sides and must be equal.
The crossfade ramps rebuilt from the segment table are the same float32
expression on both sides (2e-7, one rounding). Rendered, LUFS-normalised
tracks agree within 1e-5 · max|ref|: float32 FFT rounding at the same
nfft, carried through a loudness gain that agrees to 1e-3 LU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicsim_tpu.ops import dynamic_interp_plan, segment_plan
from sonicsim_tpu.parallel import pipeline as J
from sonicsim_tpu_torch.bridge import to_torch
from sonicsim_tpu_torch.parallel import Mesh
from sonicsim_tpu_torch.parallel import pipeline as T
from torch_threads import one_intra_op_thread  # noqa: F401

SR = 16000
REL = 1e-5


def _mixture(rng, n_src=3, t=SR, c=2, l=400):
    """Ragged per-source trajectories (3, 4, 5 waypoints)."""
    speech = rng.standard_normal((n_src, t)).astype(np.float32) * 0.1
    banks, weights, offs, lens = [], [], [], []
    for i in range(n_src):
        p = 3 + i
        traj = np.cumsum(rng.uniform(0.3, 1.0, (p, 3)), axis=0)
        bank = (rng.standard_normal((p, c, l)) * 0.02).astype(np.float32)
        bank[:, :, 0] = 1.0
        idx, w = dynamic_interp_plan(traj, t, rng=rng)
        o, le, _ = segment_plan(idx)
        banks.append(bank)
        weights.append(w)
        offs.append(o)
        lens.append(le)
    static_audio = rng.standard_normal((2, t)).astype(np.float32) * 0.1
    static_rirs = (rng.standard_normal((2, c, l)) * 0.02).astype(np.float32)
    static_rirs[:, :, 0] = 1.0
    speech_lufs = np.asarray([-17.0, -16.0, -18.0], np.float32)[:n_src]
    static_lufs = np.asarray([-24.0, -29.0], np.float32)
    return (speech, banks, weights, offs, lens, static_audio, static_rirs,
            speech_lufs, static_lufs)


def _assert_tracks(ours, ref):
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=REL * np.abs(b).max())


@pytest.mark.parametrize("static_source", [False, True])
def test_pad_moving_plans(rng, static_source):
    """Padding and the single-waypoint normalisation match exactly; torch
    banks pad to the same values as numpy banks."""
    _, banks, weights, offs, lens, *_ = _mixture(rng)
    if static_source:
        banks[1] = banks[1][:1]
        offs[1] = np.zeros(0, np.int32)
        lens[1] = np.zeros(0, np.int32)
    ours = T.pad_moving_plans(banks, weights, offs, lens)
    ref = J.pad_moving_plans(banks, weights, offs, lens)
    for a, b in zip(ours[:4], ref[:4]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert ours[4] == ref[4]
    on_dev = T.pad_moving_plans([torch.from_numpy(b) for b in banks], weights,
                                offs, lens, stack_weights=False)
    assert torch.is_tensor(on_dev[0]) and on_dev[1] is None
    np.testing.assert_array_equal(on_dev[0].numpy(), ref[0])


def test_weights_from_segments(rng):
    _, banks, weights, offs, lens, *_ = _mixture(rng)
    _, w_p, off_p, len_p, _ = J.pad_moving_plans(banks, weights, offs, lens)
    mask = np.asarray([1.0, 0.0, 1.0], np.float32)
    ours = T._weights_from_segments(off_p, len_p, mask, t=SR)
    ref = np.asarray(J._weights_from_segments(off_p, len_p, mask, t=SR))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=2e-7)
    np.testing.assert_allclose(ours[0].numpy(), w_p[0], rtol=0, atol=2e-7)


def _render_both(data, weights_form, weight_mask=None, pcm16=False):
    speech, banks, weights, offs, lens, sa, srir, sl, stl = data
    banks_p, w_p, off_p, len_p, max_seg = J.pad_moving_plans(
        banks, weights, offs, lens
    )
    if pcm16:
        speech = np.rint(np.clip(speech, -1, 0.999) * 32768).astype(np.int16)
        sa = np.rint(np.clip(sa, -1, 0.999) * 32768).astype(np.int16)
    w = w_p if weights_form else None
    args = (speech, banks_p, w, off_p, len_p, max_seg, sa, srir, sl, stl, SR)
    ours = T.render_mixture_sources(*args, weight_mask=weight_mask, device="cpu")
    ref = J.render_mixture_sources(*args, weight_mask=weight_mask)
    return ours, ref


@pytest.mark.parametrize("weights_form", [False, True])
def test_render_mixture_sources(rng, weights_form):
    ours, ref = _render_both(_mixture(rng), weights_form)
    _assert_tracks(ours, ref)


def test_render_mixture_degenerate_trajectory_mask(rng):
    """A zero-distance trajectory (all-zero host weights) keeps no ramp on
    the fused path: the weight mask zeroes it, as in the reference."""
    data = list(_mixture(rng))
    t = data[0].shape[-1]
    data[2][0] = np.zeros(t, np.float32)
    data[3][0] = np.zeros(1, np.int32)
    data[4][0] = np.asarray([t], np.int32)
    mask = np.asarray([0.0, 1.0, 1.0], np.float32)
    ours, ref = _render_both(data, False, weight_mask=mask)
    _assert_tracks(ours, ref)
    legacy, _ = _render_both(data, True)
    _assert_tracks(ours, [x.numpy() for x in legacy])


def test_render_mixture_int16_pcm(rng):
    """int16 PCM converts as i · 2^-15: the same tracks as the float
    input that PCM represents exactly, and the reference's."""
    data = list(_mixture(rng))
    ours, ref = _render_both(data, True, pcm16=True)
    _assert_tracks(ours, ref)
    q = [np.rint(np.clip(x, -1, 0.999) * 32768).astype(np.float32) / 32768
         for x in (data[0], data[5])]
    data[0], data[5] = q
    as_float, _ = _render_both(data, True)
    for a, b in zip(ours, as_float):
        assert torch.equal(a, b)


def test_render_mixture_mesh(rng):
    """One source on a mesh of two CPU devices (the second shard empty):
    the unsharded tracks, on the mesh's first device
    (tests/test_torch_mesh_render.py holds the mesh to JAX's)."""
    speech, banks, weights, offs, lens, sa, srir, sl, stl = _mixture(rng, n_src=1)
    banks_p, w_p, off_p, len_p, max_seg = T.pad_moving_plans(
        banks, weights, offs, lens
    )
    args = (speech, banks_p, w_p, off_p, len_p, max_seg, sa, srir, sl, stl, SR)
    one = T.render_mixture_sources(*args, device="cpu")
    sharded = T.render_mixture_sources(*args, mesh=Mesh(["cpu", "cpu"]))
    for a, b in zip(sharded, one):
        assert a.device.type == "cpu"
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_entry_points_default_to_the_card(rng, monkeypatch):
    """Numpy input with no device asks for the card: without CUDA the entry
    points raise and never fall back to the CPU, which runs only when asked
    for. A tensor input keeps its device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    speech, banks, weights, offs, lens, sa, srir, sl, stl = _mixture(rng, n_src=1)
    banks_p, _, off_p, len_p, max_seg = T.pad_moving_plans(banks, weights, offs, lens)
    args = (speech, banks_p, None, off_p, len_p, max_seg, sa, srir, sl, stl, SR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.render_mixture_sources(*args)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            to_torch({"speech": speech}, device)
    moving, static = T.render_mixture_sources(*args, device="cpu")
    assert moving.device.type == static.device.type == "cpu"
    from_tensor, _ = T.render_mixture_sources(torch.from_numpy(speech), *args[1:])
    assert torch.equal(from_tensor, moving)
    assert to_torch(speech, "cpu").device.type == "cpu"
