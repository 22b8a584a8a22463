"""The separation zoo on the card, held against the port on the CPU with
the same seeded weights (chip_smoke.py's phase 11 draw): each model's
forward at the full width of its configs/separation/*.yaml on 1 s, and
DPRNN-TasNet's fp32 train step (dprnn.yaml's Adam, clip and PIT neg-SNR).

Tolerances: the forward within 1e-4 · max|ref| (TF32 off; cuDNN's LSTMs
and convolutions sum in another order), the step's loss within rel 1e-5
and its clipped gradients within 1e-4 · max|g|, as phase 10 holds
ConvTasNet's.

These tests import neither jax nor the JAX package and use no conftest
fixture, so they run on the card alone:
``python -m pytest --noconftest -m cuda tests/test_torch_zoo_cuda.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from sonicsim_tpu_torch.losses import PairwiseNegSDR, PITLossWrapper
from sonicsim_tpu_torch.models import DPRNNTasNet
from sonicsim_tpu_torch.scripts.common import strict_float32
from sonicsim_tpu_torch.train import make_optimizer, make_train_step

SR = 16000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the zoo's card run")
    strict_float32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(chip_smoke.ZOO_MODELS))
def test_full_width_forward_on_the_card(cuda_device, name):
    cpu = chip_smoke.seeded_zoo(name, chip_smoke.ZOO_MODELS[name], seed=0)
    card = type(cpu)(**cpu.model_args(), device=cuda_device).eval()
    card.load_state_dict(cpu.state_dict())
    x = 0.1 * torch.from_numpy(np.random.default_rng(0).standard_normal((1, SR)).astype(np.float32))
    with torch.inference_mode():
        ref, got = cpu(x), card(x.to(cuda_device)).cpu()
    assert got.shape == ref.shape == (1, 2, SR) and bool(torch.isfinite(got).all())
    err, peak = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= 1e-4 * peak, (name, err, peak)


@pytest.mark.cuda
def test_dprnn_train_step_on_the_card(cuda_device):
    args = chip_smoke.ZOO_MODELS["DPRNNTasNet"]
    weights = chip_smoke.seeded_zoo("DPRNNTasNet", args, seed=0).state_dict()
    rng = np.random.default_rng(1)
    mix = torch.from_numpy(rng.standard_normal((2, SR)).astype(np.float32))
    tgt = torch.from_numpy(0.5 * rng.standard_normal((2, 2, SR)).astype(np.float32))
    loss_fn = PITLossWrapper(PairwiseNegSDR("snr"), pit_from="pw_mtx", threshold_byloss=False)
    sides = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = DPRNNTasNet(**args, device=dev)
        model.load_state_dict(weights)
        step = make_train_step(model, loss_fn, make_optimizer(model.parameters(), 1e-3),
                               clip_norm=5.0)
        loss = float(step(mix.to(dev), tgt.to(dev)))
        sides[dev.type] = (loss, {n: p.grad.cpu() for n, p in model.named_parameters()
                                  if p.requires_grad})
    (l_dev, g_dev), (l_cpu, g_cpu) = sides["cuda"], sides["cpu"]
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    g_max = max(float(g.abs().max()) for g in g_cpu.values())
    for n, g in g_cpu.items():
        assert float((g_dev[n] - g).abs().max()) <= 1e-4 * g_max, n
