"""The enhancement zoo and the SkiM streamer on the card, held against the
port on the CPU with the same seeded weights (chip_smoke.py's phase 12 and
13 draws): each enhancement config's model at full width on 1 s, forward and
``to_waveform``; the causal SkiM streamer at skim.yaml's widths chunk by
chunk over 1 s.

Tolerances: within 1e-4 · max|ref| (TF32 off; cuDNN's LSTMs and
convolutions sum in another order), as phase 13 holds the 4 s crops.

These tests import neither jax nor the JAX package and use no conftest
fixture, so they run on the card alone:
``python -m pytest --noconftest -m cuda tests/test_torch_enh_cuda.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from sonicsim_tpu_torch.models import SkiMStreamer
from sonicsim_tpu_torch.scripts.common import make_forward, strict_float32

SR = 16000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the enhancement zoo's card run")
    strict_float32()
    return torch.device("cuda")


def _card_copy(cpu, device):
    card = type(cpu)(**cpu.model_args(), device=device).eval()
    card.load_state_dict(cpu.state_dict())
    return card


@pytest.mark.cuda
@pytest.mark.parametrize("stem", list(chip_smoke.ENH_MODELS))
def test_full_width_forward_on_the_card(cuda_device, stem):
    name, args = chip_smoke.ENH_MODELS[stem]
    cpu = chip_smoke.seeded_zoo(name, args, seed=0)
    card = _card_copy(cpu, cuda_device)
    x = 0.1 * torch.from_numpy(np.random.default_rng(0).standard_normal((1, SR)).astype(np.float32))
    ref, got = make_forward(cpu)(x), make_forward(card)(x.to(cuda_device)).cpu()
    assert got.shape == ref.shape == (1, 1, SR) and bool(torch.isfinite(got).all())
    err, peak = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= 1e-4 * peak, (stem, err, peak)


@pytest.mark.cuda
def test_skim_streamer_on_the_card(cuda_device):
    cpu = chip_smoke.seeded_zoo("SkiMNet", chip_smoke.STREAMING["model"], seed=0)
    sides = [SkiMStreamer(cpu), SkiMStreamer(_card_copy(cpu, cuda_device))]
    x = 0.1 * torch.from_numpy(np.random.default_rng(1).standard_normal((1, SR)).astype(np.float32))
    chunk = sides[0].chunk_samples
    for s in range(0, SR, chunk):
        ref = sides[0].step(x[:, s:s + chunk])
        got = sides[1].step(x[:, s:s + chunk].to(cuda_device)).cpu()
        assert got.shape == ref.shape
        if ref.numel():
            err, peak = float((got - ref).abs().max()), float(ref.abs().max())
            assert err <= 1e-4 * peak, (s, err, peak)
