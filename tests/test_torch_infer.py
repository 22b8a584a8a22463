"""The port's inference pieces against the JAX package's, on the same numpy
inputs: STFT/iSTFT, the spectral embedding, segment stitching, the energy
VAD and ``to_waveform``.

Tolerances: STFT and iSTFT within 1e-5 · max|ref| (float32 FFTs of the same
frames); the embedding within 1e-5 (its pooling sums in float64 here, in
float32 in JAX); stitching picks the same permutations; the VAD (numpy, a
copy) gives equal spans.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonicsim_tpu.infer as JI
import sonicsim_tpu_torch.infer as TI
import sonicsim_tpu_torch.ops.stft as TS
from sonicsim_tpu_torch import models as TM
from torch_threads import one_intra_op_thread  # noqa: F401

JS = importlib.import_module("sonicsim_tpu.ops.stft")  # ops exports a function `stft`
SR = 16000
REL = 1e-5


def _close(ours, ref, rel=REL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("periodic", [True, False])
def test_windows(periodic):
    _close(TS.hann_window(400, periodic, device="cpu"), JS.hann_window(400, periodic))
    _close(TS.sqrt_hann_window(256, periodic, device="cpu"), JS.sqrt_hann_window(256, periodic))


@pytest.mark.parametrize("n_fft,hop,length", [(512, 128, 8000), (256, 100, 7777)])
def test_stft_istft(n_fft, hop, length):
    x = np.random.default_rng(0).standard_normal((2, length)).astype(np.float32)
    wj, wt = JS.hann_window(n_fft), TS.hann_window(n_fft, device="cpu")
    ref = np.asarray(JS.stft(jnp.asarray(x), n_fft, hop, wj))
    ours = TS.stft(torch.from_numpy(x), n_fft, hop, wt)
    _close(ours.real, ref.real)
    _close(ours.imag, ref.imag)
    for n in (length, None):
        back_ref = np.asarray(JS.istft(jnp.asarray(ref), n_fft, hop, wj, length=n))
        back = TS.istft(ours, n_fft, hop, wt, length=n)
        _close(back, back_ref)
    _close(TS.istft(ours, n_fft, hop, wt, length=length), x, 1e-4)  # round trip


def _voices(rng, t=SR):
    """Two sources of different spectral envelopes."""
    n = np.arange(t) / SR
    low = np.sin(2 * np.pi * 150 * n) * (1 + 0.5 * np.sin(2 * np.pi * 3 * n))
    high = rng.standard_normal(t) * np.sin(2 * np.pi * 2500 * n)
    return np.stack([low, high]).astype(np.float32)


def test_spectral_embedding():
    x = _voices(np.random.default_rng(1))
    for src in x:
        _close(TI.spectral_embedding(src, SR, device="cpu"), JI.spectral_embedding(src, SR))


def test_stitch_segments_same_permutations():
    rng = np.random.default_rng(2)
    ordered = [_voices(rng, SR // 2) * rng.uniform(0.5, 1.5) for _ in range(6)]
    segs = [s[::-1].copy() if k % 2 else s for k, s in enumerate(ordered)]  # swaps
    ours = TI.stitch_segments(segs, SR, device="cpu")
    ref = JI.stitch_segments(segs, SR)
    for a, b, want in zip(ours, ref, ordered):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, want)  # back in the first segment's order
    np.testing.assert_array_equal(TI.concatenate_tracks(ours), JI.concatenate_tracks(ref))


def test_energy_vad_and_segment_mixture():
    rng = np.random.default_rng(3)
    x = 1e-3 * rng.standard_normal(3 * SR).astype(np.float32)
    x[4000:12000] += 0.3 * np.sin(np.arange(8000) * 0.05)
    x[30000:40000] += 0.2 * rng.standard_normal(10000)
    assert TI.energy_vad(x, SR) == JI.energy_vad(x, SR)
    assert TI.segment_mixture(x, SR) == JI.segment_mixture(x, SR) != []


def test_to_waveform():
    model = TM.ConvTasNet(N=16, L=16, B=8, H=16, X=1, R=1, device="cpu")
    out = np.random.default_rng(4).standard_normal((2, 2, 900)).astype(np.float32)
    ours = TI.to_waveform(model, torch.from_numpy(out), 800)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(JI.to_waveform(model, jnp.asarray(out), 800)))
    assert TI.to_waveform(model, torch.from_numpy(out[:, 0]), 800).shape == (2, 1, 800)

    class GaGNet:  # the GaGNet family: the last stage, decompressed
        n_fft, hop_length = 64, 32

    stages = np.random.default_rng(5).standard_normal((2, 2, 2, 33, 26)).astype(np.float32)
    ours = TI.to_waveform(GaGNet(), list(torch.from_numpy(stages)), 800)
    want = np.asarray(JI.to_waveform(GaGNet(), list(jnp.asarray(stages)), 800))
    np.testing.assert_allclose(ours.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
