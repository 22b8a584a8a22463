"""Enhancement training on the card, held against the same step on the CPU
with chip_smoke.py's seeded weights (phase 14's draw): one float32 train
step at full width, with the config's loss, Adam and clip, of FullSubnet
(stacked LSTMs, through cuDNN's RNN, ROADMAP C12) and of GaGNet (channel
PReLUs after instance norms), on B=2 x 1 s of seeded speech-like noise.

Tolerances: phase 14's, ``chip_smoke.enh_step_check``, every side on the
card's branch at each kinked activation (an element sent apart within
``KINK_REL`` · max|x| of 0): the step in float64 on the card within
``F64_REL`` (1e-9) · max|g64| of float64 on the CPU; in float32 the loss
within rel 1e-5 and the clipped gradients within max(1e-4, ``ILL_FACTOR``
times the CPU's float32 steps' distance from float64, two summation
orders) · max|g|.

These tests import neither jax nor the JAX package and use no conftest
fixture, so they run on the card alone:
``python -m pytest --noconftest -m cuda tests/test_torch_enh_train_cuda.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from sonicsim_tpu_torch.models import get
from sonicsim_tpu_torch.scripts.common import strict_float32
from sonicsim_tpu_torch.train import make_optimizer, make_train_step

SR = 16000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: enhancement training on the card")
    strict_float32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stem", ["fullsubnet", "gagnet"])
def test_full_width_train_step_on_the_card(cuda_device, stem):
    name, args = chip_smoke.ENH_MODELS[stem]
    loss_node, _ = chip_smoke.ENH_LOSSES[stem]
    loss_fn = chip_smoke._instantiate_loss(loss_node)
    weights = chip_smoke.seeded_zoo(name, args, seed=0).state_dict()
    rng = np.random.default_rng(2)
    t = np.arange(SR) / SR
    clean = 0.1 * rng.standard_normal((2, SR)) + 0.2 * np.sin(2 * np.pi * 220 * t)
    mix = torch.from_numpy((clean + 0.05 * rng.standard_normal((2, SR))).astype(np.float32))
    clean = torch.from_numpy(clean.astype(np.float32))

    def fresh(dev):
        model = get(name)(**args, device=dev)
        model.load_state_dict(weights)
        return model, make_train_step(model, loss_fn, make_optimizer(model.parameters(), 1e-3),
                                      clip_norm=5.0)

    chk = chip_smoke.enh_step_check(fresh, mix, clean, cuda_device)
    print(chip_smoke._step_check_line(chk))
    assert not chip_smoke.step_check_failures(chk), chk
