"""K1's ramp form: the ownership select that applies the crossfade ramp as it
reads the two irfft outputs in place.

Its plain version against the formulations it replaces, on the CPU: the
separate ramp tensor, multiply, add and select of the port's earlier
epilogue (bit for bit: the same float32 ops in the same order), and the JAX
package's fused epilogue, ``_fused_lerp_select`` and the Pallas
``select_segments`` over the JAX-combined windows (within 1e-6 absolute on
O(1) inputs: the same ops, but the ramp as XLA rounds ``u − lead`` and
``u + shift``, which agree exactly for integers below 2^24, so any
difference is one rounding of the final add).

Operands are (B, N, C, nfft) arrays sliced at the overlap-save offset, as
the render lays them out, with B = 2 rows of different data.

The card's tests import neither jax nor the JAX package and use no conftest
fixture: ``python -m pytest --noconftest -m cuda tests/test_torch_select_ramp.py``.
"""

import numpy as np
import pytest
import torch

from sonicsim_tpu_torch.ops import (
    dynamic_interp_plan,
    kernels,
    moving_block_plan,
    segment_plan,
)
from torch_threads import one_intra_op_thread  # noqa: F401

ATOL = 1e-6
LEAD = 7  # the overlap-save slice start l − 1: odd, so rows are misaligned
CASES = {"long": (40000, 4, False), "short": (40000, 9, True)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _plan(seed, case):
    """Segment tables of one case (tests/test_torch_kernels.CASES): ``short``
    adds padding entries at off == t with length 0."""
    t, p, short = CASES[case]
    rng = np.random.default_rng(seed)
    positions = np.cumsum(rng.uniform(0.3, 0.6, (p, 3)), axis=0)
    idx, _ = dynamic_interp_plan(positions, t, rng=rng)
    off, le, max_seg = segment_plan(idx)
    if short:
        off = np.concatenate([off, np.full(3, t, np.int32)])
        le = np.concatenate([le, np.zeros(3, np.int32)])
    return off.astype(np.int32), le.astype(np.int32), max_seg + 128, t


def _windows(seed, n, span, c=2, bsz=2):
    """conv_s, conv_d as (B, N, C, nfft) numpy arrays and the slice that
    cuts the (B, N, C, span) windows out of them."""
    rng = np.random.default_rng(seed + 100)
    nfft = span + LEAD + 37
    full = rng.standard_normal((2, bsz, n, c, nfft)).astype(np.float32)
    return full[0], full[1], slice(LEAD, LEAD + span)


def _segmented(seed, case):
    """Segmented-path operands: strided torch views, (B, N) tables and the
    segmented ramp's shift = −(off − off_al), scale = 1/max(len, 1)."""
    off, le, span, t = _plan(seed, case)
    off_al = off - off % 128
    fs, fd, sl = _windows(seed, len(off), span)
    conv_s = torch.from_numpy(fs)[..., sl]
    conv_d = torch.from_numpy(fd)[..., sl]
    tab = lambda x: torch.from_numpy(x).expand(2, -1)  # noqa: E731
    shift = tab(off_al - off).to(torch.float32)
    scale = 1.0 / torch.clamp(tab(le).to(torch.float32), min=1.0)
    return dict(off=off, off_al=off_al, le=le, span=span, t=t, fs=fs, fd=fd,
                sl=sl, conv_s=conv_s, conv_d=conv_d, o=tab(off), a=tab(off_al),
                shift=shift, scale=scale)


def _ramp_form(k):
    return kernels.select_segments_ref(k["conv_s"], k["o"], k["a"], k["t"],
                                       k["conv_d"], k["shift"], k["scale"])


@pytest.mark.parametrize("case", ["long", "short"])
def test_ramp_form_equals_separate_epilogue(case):
    """The ramp form is the earlier epilogue (ramp (u − lead)/len as its own
    tensor, times conv_d, plus conv_s, then the select form), bit for bit."""
    k = _segmented(0, case)
    u = torch.arange(k["span"], dtype=torch.float32)
    lead = (k["o"] - k["a"]).to(torch.float32)[..., None]
    inv_len = 1.0 / torch.clamp(torch.from_numpy(k["le"]).to(torch.float32),
                                min=1.0)[..., None]
    ramp = (u - lead) * inv_len
    combined = k["conv_s"] + ramp[:, :, None, :] * k["conv_d"]
    want = kernels.select_segments_ref(combined, k["o"], k["a"], k["t"])
    torch.testing.assert_close(_ramp_form(k), want, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["long", "short"])
def test_ramp_form_matches_jax_fused_epilogue(case):
    """Against the JAX package's native-FFT fused epilogue
    (fftconv.convolve_moving_segmented: _window_ramp, then
    _fused_lerp_select), and in the "long" case, where every segment spans
    the Pallas BLOCK, against the Pallas select over the same windows."""
    import jax.numpy as jnp

    from sonicsim_tpu.ops import fftconv as jfft
    from sonicsim_tpu.ops import pallas_kernels as jpk

    k = _segmented(1, case)
    ours = _ramp_form(k).numpy()
    off, off_al = jnp.asarray(k["off"]), jnp.asarray(k["off_al"])
    ramp = jfft._window_ramp(off, off_al, jnp.asarray(k["le"]), k["span"])
    for b in range(2):
        combined = (jnp.asarray(k["fs"][b])[..., k["sl"]]
                    + ramp[:, None, :] * jnp.asarray(k["fd"][b])[..., k["sl"]])
        ref = jfft._fused_lerp_select(combined, off, off_al, k["t"])
        np.testing.assert_allclose(ours[b], np.asarray(ref), rtol=0, atol=ATOL)
        if case == "long":
            assert int(np.diff(np.append(k["off"], k["t"])).min()) >= jpk.BLOCK
            pallas = jpk.select_segments(combined, off, off_al, k["t"],
                                         interpret=True)
            np.testing.assert_allclose(ours[b], np.asarray(pallas), rtol=0,
                                       atol=ATOL)


@pytest.mark.parametrize("case", ["long", "short"])
def test_blocked_ramp_form_matches_jax(case):
    """The blocked path's shift = off_al − seg_off, scale = inv_len·w_scale
    against the JAX blocked ramp (fftconv.convolve_moving_blocked, native
    FFT branch) over the same windows, with w_scale (1, 0): a degenerate
    trajectory's row keeps no ramp."""
    import jax.numpy as jnp

    from sonicsim_tpu.ops import fftconv as jfft

    seg_off, seg_len, _, t = _plan(2, case)
    block = 8192  # short tail blocks, and padding blocks at off == t
    boff, bseg = moving_block_plan(seg_off, seg_len, t, block,
                                   -(-t // block) + len(seg_off) + 2)
    off_al = boff - boff % 128
    span = block + 128
    fs, fd, sl = _windows(2, len(boff), span)
    w_scale = np.asarray([1.0, 0.0], np.float32)

    so = torch.from_numpy(seg_off[bseg]).expand(2, -1)
    inv_len = 1.0 / torch.clamp(torch.from_numpy(seg_len[bseg]).expand(2, -1),
                                min=1).to(torch.float32)
    inv_len = inv_len * torch.from_numpy(w_scale).reshape(-1, 1)
    a = torch.from_numpy(off_al).expand(2, -1)
    ours = kernels.select_segments_ref(
        torch.from_numpy(fs)[..., sl], torch.from_numpy(boff).expand(2, -1), a,
        t, torch.from_numpy(fd)[..., sl], (a - so).to(torch.float32), inv_len,
    ).numpy()

    jso = jnp.take(jnp.asarray(seg_off), jnp.asarray(bseg))
    j_inv = 1.0 / jnp.maximum(jnp.take(jnp.asarray(seg_len), jnp.asarray(bseg)),
                              1).astype(jnp.float32)
    u = jnp.arange(span, dtype=jnp.float32)[None, :]
    for b in range(2):
        ramp = ((jnp.asarray(off_al) - jso).astype(jnp.float32)[:, None] + u) \
            * (j_inv * w_scale[b])[:, None]
        combined = (jnp.asarray(fs[b])[..., sl]
                    + ramp[:, None, :] * jnp.asarray(fd[b])[..., sl])
        ref = jfft._fused_lerp_select(combined, jnp.asarray(boff),
                                      jnp.asarray(off_al), t)
        np.testing.assert_allclose(ours[b], np.asarray(ref), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        ours[1], kernels.select_segments_ref(
            torch.from_numpy(fs[1:])[..., sl], torch.from_numpy(boff)[None],
            torch.from_numpy(off_al)[None], t)[0].numpy(),
    )


@pytest.mark.parametrize("case", ["long", "short"])
def test_ramp_wrapper_takes_plain_path_on_cpu(case):
    """On CPU tensors the wrapper is the plain version, float64 included,
    and counts no launch."""
    k = _segmented(3, case)
    before = dict(kernels.LAUNCHES)
    args = (k["conv_s"], k["o"], k["a"], k["t"], k["conv_d"], k["shift"], k["scale"])
    torch.testing.assert_close(kernels.select_segments(*args), _ramp_form(k),
                               rtol=0, atol=0)
    f64 = [x.double() if torch.is_tensor(x) and x.is_floating_point() else x
           for x in args]
    out64 = kernels.select_segments(*f64)
    assert out64.dtype == torch.float64
    torch.testing.assert_close(out64, kernels.select_segments_ref(*f64),
                               rtol=0, atol=0)
    assert kernels.LAUNCHES == before


def test_ramp_wrapper_rejects_bad_arguments():
    k = _segmented(4, "short")
    cs, cd, o, a, t = k["conv_s"], k["conv_d"], k["o"], k["a"], k["t"]
    sh, sc = k["shift"], k["scale"]
    with pytest.raises(ValueError, match="unit stride"):
        kernels.select_segments(cs.transpose(2, 3).contiguous().transpose(2, 3),
                                o, a, t, cd, sh, sc)
    with pytest.raises(ValueError, match="unit stride"):
        wide = torch.zeros(*cs.shape[:3], 2 * cs.shape[3])
        kernels.select_segments(wide[..., ::2], o, a, t)
    with pytest.raises(ValueError, match="conv_d must match"):
        kernels.select_segments(cs, o, a, t, cd[..., 1:], sh, sc)
    with pytest.raises(ValueError, match="conv_d strides"):
        kernels.select_segments(cs, o, a, t, cd.contiguous(), sh, sc)
    with pytest.raises(ValueError, match="needs shift"):
        kernels.select_segments(cs, o, a, t, cd, sh[:, 1:], sc)
    with pytest.raises(ValueError, match="needs scale"):
        kernels.select_segments(cs, o, a, t, cd, sh, sc[0])
    with pytest.raises(ValueError, match="needs scale"):
        kernels.select_segments(cs, o, a, t, cd, sh, None)
    with pytest.raises(ValueError, match="go with conv_d"):
        kernels.select_segments(cs, o, a, t, None, sh, sc)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long", "short"])
def test_ramp_form_kernel_matches_plain(cuda_device, case):
    """The kernel reads the strided views in place and agrees with its plain
    version bit for bit (each op rounded, no fused multiply-add)."""
    k = _segmented(0, case)
    full_s = torch.from_numpy(k["fs"]).to(cuda_device)
    full_d = torch.from_numpy(k["fd"]).to(cuda_device)
    args = (full_s[..., k["sl"]], k["o"].to(cuda_device), k["a"].to(cuda_device),
            k["t"], full_d[..., k["sl"]], k["shift"].to(cuda_device),
            k["scale"].to(cuda_device))
    n0 = kernels.LAUNCHES["select_segments_ramp"]
    out = kernels.select_segments(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["select_segments_ramp"] == n0 + 1
    torch.testing.assert_close(out, kernels.select_segments_ref(*args),
                               rtol=0, atol=0)
