"""One float32 train step on the card against the same step on the CPU, at
the full width of configs/separation/convtasnet.yaml, from the same weights
and batch.

Tolerances: the loss within rel 1e-5; the clipped gradients the optimizer
takes within 1e-4 · max|g_cpu| (TF32 off; cuDNN sums in another order).
Parameters after the step are not compared: at step 1 Adam moves each by
lr·g/(|g| + eps), so a near-zero gradient whose sign differs between the
two sides moves its parameter by up to 2·lr.

These tests import neither jax nor the JAX package and use no conftest
fixture, so they run on the card alone:
``python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py``.
"""

import numpy as np
import pytest
import torch

from sonicsim_tpu_torch.losses import PairwiseNegSDR, PITLossWrapper
from sonicsim_tpu_torch.models import ConvTasNet
from sonicsim_tpu_torch.scripts.common import strict_float32
from sonicsim_tpu_torch.train import make_optimizer, make_train_step

SR = 16000
FULL = dict(N=512, L=32, B=128, H=512, P=3, X=8, R=3, norm="gLN", num_spks=2,
            activate="relu", causal=False, sample_rate=SR)  # convtasnet.yaml
LOSS_REL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the training path's card run")
    strict_float32()
    return torch.device("cuda")


@pytest.mark.cuda
def test_f32_train_step_on_card_matches_cpu(cuda_device):
    torch.manual_seed(0)
    cpu = ConvTasNet(**FULL, device="cpu")
    card = ConvTasNet(**FULL, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    mix = torch.from_numpy((0.1 * rng.standard_normal((2, SR))).astype(np.float32))
    tgt = torch.from_numpy((0.1 * rng.standard_normal((2, 2, SR))).astype(np.float32))
    loss_fn = PITLossWrapper(PairwiseNegSDR("snr"), threshold_byloss=False)
    out = {}
    for model, dev in ((cpu, "cpu"), (card, cuda_device)):
        step = make_train_step(model, loss_fn, make_optimizer(model.parameters(), 1e-3))
        loss = float(step(mix.to(dev), tgt.to(dev)))
        out[dev if dev == "cpu" else "card"] = (
            loss, {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out["card"]
    assert np.isfinite(l_card) and l_card == pytest.approx(l_cpu, rel=LOSS_REL)
    g_max = max(float(g.abs().max()) for g in g_cpu.values())
    err = max(float((g_card[n] - g).abs().max()) for n, g in g_cpu.items())
    assert err <= GRAD_REL * g_max, (err, g_max)
