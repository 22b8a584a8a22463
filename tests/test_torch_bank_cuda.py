"""The RIR-bank render on the card against the same port function on the CPU,
at ``bench_all.py``'s bank shapes: 3 banks × 40 waypoints, one binaural
receiver, 32 bands, image order 4 (240 items of 5,832 images, 6,355 taps).

Tolerance: the JAX package's bank-vs-serial bound (tests/test_bank_render.py
:51), 5e-5·peak absolute and 1e-3 relative: cuFFT, cuBLAS and the card's
transcendentals round otherwise than the CPU's. Repeats on the card must be
bit-identical: the render has no atomics.

These tests import neither jax nor the JAX package and use no conftest
fixture, so they run on the card alone:
``python -m pytest --noconftest -m cuda tests/test_torch_bank_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sonicsim_tpu_torch.sim import (
    ChannelModel,
    ShoeboxRoom,
    SyntheticRirOracle,
    render_bank_batched,
    render_rir_banks,
)

ATOL, RTOL = 5e-5, 1e-3  # atol is a fraction of the peak
MIC = [np.array([4.0, 1.5, 3.0])]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bank's card path runs only there")
    return torch.device("cuda")


def _scene():
    room = ShoeboxRoom((8.0, 3.0, 6.0), absorption=0.3)
    return SyntheticRirOracle(room, n_bands=32, max_order=4), ChannelModel("Binaural")


def _ways(k, n=40):
    r = np.random.default_rng(1000 + k)
    return [r.uniform([1, 1, 1], [7, 2.5, 5]) for _ in range(n)]


@pytest.mark.cuda
def test_bank_on_card_matches_cpu(cuda_device):
    oracle, ch = _scene()
    srcs = _ways(0)[:4]  # 8 items
    got = render_bank_batched(oracle, srcs, MIC, ch, peak_normalize=False)
    ref = render_bank_batched(dataclasses.replace(oracle, device="cpu"), srcs, MIC,
                              ch, peak_normalize=False)
    assert got.shape == ref.shape == (4, 1, 2, 6355)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL * np.abs(ref).max())


@pytest.mark.cuda
def test_bank_on_card_repeats_bit_identical(cuda_device):
    oracle, ch = _scene()
    lists = [_ways(k) for k in range(3)]
    first = render_rir_banks(oracle, lists, MIC, ch, out_device=True)
    again = render_rir_banks(oracle, lists, MIC, ch, out_device=True)
    for a, b in zip(first, again):
        assert a.device.type == "cuda" and a.shape == (40, 1, 2, 6355)
        assert torch.equal(a, b)
        assert float(a.abs().max()) == 1.0
