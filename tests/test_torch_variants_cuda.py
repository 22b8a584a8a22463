"""The model variants no config takes on the card, each at its config's
full width with the flag flipped (chip_smoke.VARIANT_FLAGS) and
chip_smoke.py's seeded weights: the float32 forward against the port on
the CPU on 1 s of seeded noise within ``ZOO_REL`` (1e-4) · max|ref|, and
one float32 train step with the config's loss, Adam and clip held by
``chip_smoke.enh_step_check`` (phase 14's rule: float64 on the card within
1e-9 · max|g64| of the CPU's, float32 within max(1e-4, ``ILL_FACTOR`` times
the CPU's float32 distance from float64) · max|g|) on B=2 x 0.5 s.

These tests import neither jax nor the JAX package and use no conftest
fixture, so they run on the card alone:
``python -m pytest --noconftest -m cuda tests/test_torch_variants_cuda.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from sonicsim_tpu_torch.models import get
from sonicsim_tpu_torch.scripts.common import make_forward, strict_float32
from sonicsim_tpu_torch.train import make_optimizer, make_train_step

SR = 16000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the variants on the card")
    strict_float32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stem", list(chip_smoke.VARIANT_FLAGS))
def test_variant_forward_and_step_on_the_card(cuda_device, stem):
    config, flag = chip_smoke.VARIANT_FLAGS[stem]
    name, base = chip_smoke.ENH_MODELS[config]
    args = dict(base, **flag)
    cpu = chip_smoke.seeded_zoo(name, args, seed=0)
    rng = np.random.default_rng(2)
    t = np.arange(SR) / SR
    clean = 0.1 * rng.standard_normal((2, SR)) + 0.2 * np.sin(2 * np.pi * 220 * t)
    mix = torch.from_numpy((clean + 0.05 * rng.standard_normal((2, SR))).astype(np.float32))
    clean = torch.from_numpy(clean.astype(np.float32))

    model = get(name)(**args, device=cuda_device)
    model.load_state_dict(cpu.state_dict())
    ref = make_forward(cpu.eval())(mix[:1])
    got = make_forward(model.eval())(mix[:1].to(cuda_device)).cpu()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= chip_smoke.ZOO_REL * float(ref.abs().max())

    loss_fn = chip_smoke._instantiate_loss(chip_smoke.ENH_LOSSES[config][0])
    weights = cpu.state_dict()

    def fresh(dev):
        m = get(name)(**args, device=dev)
        m.load_state_dict(weights)
        return m, make_train_step(m, loss_fn, make_optimizer(m, 1e-3), clip_norm=5.0)

    half = SR // 2
    chk = chip_smoke.enh_step_check(fresh, mix[:, :half], clean[:, :half], cuda_device)
    print(chip_smoke._step_check_line(chk))
    assert not chip_smoke.step_check_failures(chk), chip_smoke.step_check_failures(chk)
