"""The port's BS.1770 meter against the JAX package's, on the CPU.

Tolerances: loudness values within 1e-3 LU (float32 sums in another order);
K-weighted signals within 1e-5 · max|ref| (float32 FFT rounding at the same
block size); the sequential biquads against the reference's associative
scan within 1e-4 · max|ref| (the scan re-associates the float32
recurrence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicsim_tpu.ops import loudness as J
from sonicsim_tpu_torch.ops import loudness as T
from torch_threads import one_intra_op_thread  # noqa: F401

SR = 16000
LU_TOL = 1e-3


def _close(ours, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("rate", [16000, 48000])
def test_coeffs_and_fir(rate):
    for (tb, ta), (jb, ja) in zip(T.k_weighting_coeffs(rate),
                                  J.k_weighting_coeffs(rate)):
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(T._kweight_fir(rate), J._kweight_fir(rate))


@pytest.mark.parametrize("shape", [(3000,), (2, 20000)])
def test_k_weight_fir_blocks(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    _close(T.k_weight(torch.from_numpy(x), SR),
           J.k_weight(jnp.asarray(x), SR), 1e-5)


def test_k_weight_exact_biquads(rng):
    x = rng.standard_normal((2, 1500)).astype(np.float32)
    ref = jax.jit(lambda v: J.k_weight(v, SR, exact=True))(jnp.asarray(x))
    _close(T.k_weight(torch.from_numpy(x), SR, exact=True), ref, 1e-4)


@pytest.mark.parametrize(
    "shape,block_size",
    [((2, 32000), 0.4), ((24000,), 0.4), ((2, 20000), 0.3), ((7, 16000), 0.4)],
)
def test_integrated_loudness(rng, shape, block_size):
    """75%-overlap fast path (stereo, mono, 7 channels beyond BS.1770's
    five weights) and the general cumsum path (0.3 s blocks)."""
    x = rng.standard_normal(shape).astype(np.float32) * 0.1
    x[..., : shape[-1] // 3] *= 0.01  # quiet third exercises the gates
    ours = float(T.integrated_loudness(torch.from_numpy(x), SR, block_size))
    ref = float(J.integrated_loudness(jnp.asarray(x), SR, block_size=block_size))
    assert abs(ours - ref) <= LU_TOL


def test_integrated_loudness_batched_and_silence(rng):
    x = rng.standard_normal((3, 2, 16000)).astype(np.float32) * 0.1
    x[1] = 0.0
    ours = T.integrated_loudness(torch.from_numpy(x), SR)
    assert ours.shape == (3,)
    assert ours[1] == -np.inf
    for i in (0, 2):
        ref = float(J.integrated_loudness(jnp.asarray(x[i]), SR))
        assert abs(float(ours[i]) - ref) <= LU_TOL


@pytest.mark.parametrize("t", [16000, 4000])
def test_lufs_norm(rng, t):
    """Normalisation, including the sub-400 ms block shrink (t = 4000)
    and the −40 LUFS fallback for a silent item, batched."""
    x = rng.standard_normal((3, 2, t)).astype(np.float32) * 0.1
    x[2] = 0.0
    targets = np.asarray([-17.0, -24.0, -29.0], np.float32)
    out, gain = T.lufs_norm(torch.from_numpy(x), SR, torch.from_numpy(targets))
    for i in range(3):
        ref, ref_gain = J.lufs_norm(jnp.asarray(x[i]), SR, float(targets[i]))
        _close(out[i], ref, 1e-4)
        assert abs(float(gain[i]) / float(ref_gain) - 1.0) <= 1e-3 * np.log(10) / 20
    assert float(gain[2]) == pytest.approx(10 ** ((-29.0 + 40.0) / 20), rel=1e-6)
    again = T.integrated_loudness(out[:2], SR, min(0.4, t / SR))
    np.testing.assert_allclose(again.numpy(), targets[:2], atol=LU_TOL)


def test_loudness_normalize_scalar():
    x = torch.ones(2, 10)
    out, gain = T.loudness_normalize(x, -30.0, -10.0)
    assert float(gain) == pytest.approx(10.0)
    assert torch.equal(out, x * 10.0)
