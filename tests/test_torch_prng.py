"""The port's threefry-2x32 stream (``sonicsim_tpu_torch.sim.prng``) against
``jax.random``, as the renderers draw their tail noise:
``normal(fold_in(PRNGKey(seed), channel), (n,), float32)``.

Tolerances: keys, raw bits and uniforms follow the same integer recipe and
must be equal. Normals are √2·erfinv of equal uniforms; torch's erfinv and
XLA's erf_inv polynomial differ by up to 2.0e-5 absolute over 200,000 draws
(5.2e-6 relative), so normals are held to 3e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicsim_tpu.sim.image_source import tail_noise, tail_noise_key
from sonicsim_tpu_torch.sim import image_source as T
from sonicsim_tpu_torch.sim import prng
from torch_threads import one_intra_op_thread  # noqa: F401

SEEDS = [0, 1, 2**31 - 1, 2**31 + 5, 2**32 - 1]
CHANNELS = [0, 1, 3]
LENGTHS = [1, 7, 6355]
NORMAL_ATOL = 3e-5
LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


def _words(k) -> np.ndarray:
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("chan", CHANNELS)
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_uniforms_normals(seed, chan):
    """From a Python int and from a jitted uint32 key alike (the bank's and
    the serial renderer's derivations), every length."""
    assert np.array_equal(_words(jax.random.PRNGKey(seed)), prng.key(seed).numpy())
    by_int = jax.random.fold_in(jax.random.PRNGKey(seed), chan)
    traced = jax.jit(tail_noise_key)(np.uint32(seed), np.int32(chan))
    ours = prng.fold_in(prng.key(seed), chan)
    np.testing.assert_array_equal(ours.numpy(), _words(by_int))
    np.testing.assert_array_equal(ours.numpy(), _words(traced))
    for n in LENGTHS:
        bits = jax.random.bits(by_int, (n,), jnp.uint32)
        np.testing.assert_array_equal(prng.random_bits(ours, n).numpy(), _words(bits))
        u = jax.random.uniform(by_int, (n,), jnp.float32, LO, 1.0)
        np.testing.assert_array_equal(prng.uniform(ours, n, float(LO), 1.0).numpy(),
                                      np.asarray(u))
        np.testing.assert_array_equal(prng.uniform(ours, n).numpy(),
                                      np.asarray(jax.random.uniform(by_int, (n,))))
        got = T.tail_noise(seed, chan, n, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_allclose(got.numpy(), np.asarray(tail_noise(seed, chan, n)),
                                   rtol=0, atol=NORMAL_ATOL)


def test_batched_keys_match_vmap():
    """A batch of (seed, channel) keys, as the bank derives them on the
    device: jax.vmap over uint32 seeds and int32 channels."""
    seeds = np.asarray(SEEDS * 3, np.int64)
    chans = np.repeat(np.asarray(CHANNELS, np.int64), len(SEEDS))
    ref = jax.vmap(tail_noise_key)(seeds.astype(np.uint32), chans.astype(np.int32))
    keys = prng.fold_in(prng.key(torch.from_numpy(seeds)), torch.from_numpy(chans))
    np.testing.assert_array_equal(keys.numpy(), _words(ref))
    ref_n = jax.vmap(lambda k: jax.random.normal(k, (257,), jnp.float32))(ref)
    np.testing.assert_allclose(prng.normal(keys, 257).numpy(), np.asarray(ref_n),
                               rtol=0, atol=NORMAL_ATOL)


def test_normal_moments():
    """200,000 draws of one stream: mean 0 and variance 1 within sampling
    error, and the worst gap to jax's normals inside the tolerance."""
    n = 200_000
    ours = T.tail_noise(7, 1, n, device="cpu").double()
    assert abs(float(ours.mean())) < 5 / np.sqrt(n)
    assert abs(float(ours.var()) - 1.0) < 5 * np.sqrt(2 / n)
    ref = np.asarray(tail_noise(7, 1, n))
    assert np.abs(ours.numpy() - ref).max() <= NORMAL_ATOL
