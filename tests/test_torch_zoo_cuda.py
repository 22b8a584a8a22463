"""The separation zoo on the card, held against the port on the CPU with
the same seeded weights (chip_smoke.py's phase 11 draw): each model's
forward at the full width of its configs/separation/*.yaml on 1 s, and
each config's fp32 train step (its optimizer and clip, PIT neg-SNR;
chip_smoke.py's phase 15).

Tolerances: the forward within 1e-4 · max|ref| (TF32 off; cuDNN's LSTMs
and convolutions sum in another order). The train steps are held by
``chip_smoke.enh_step_check``, phase 14's and 15's rule: every side
replays the card's branch at each kinked activation and PIT's choice of
permutation; the step in float64 on the card within ``F64_REL`` (1e-9)
· max|g64| of float64 on the CPU; in float32 the loss within rel 1e-5 and
the clipped gradients within max(1e-4, ``ILL_FACTOR`` (2) times the CPU's
own float32 distance from its float64 step, the larger of its default
thread count and two threads) · max|g|. ROADMAP C12: the mossformer case
fails in float32, the card's float32 step lying further from float64
than twice the CPU's.

These tests import neither jax nor the JAX package and use no conftest
fixture, so they run on the card alone:
``python -m pytest --noconftest -m cuda tests/test_torch_zoo_cuda.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from sonicsim_tpu_torch.scripts.common import strict_float32

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


def _held(chk: dict) -> None:
    print(chip_smoke._step_check_line(chk))
    assert not chip_smoke.step_check_failures(chk), chk


@pytest.mark.cuda
def test_dprnn_train_step_on_the_card(cuda_device):
    """dprnn.yaml's step on B=2 x 1 s of seeded noise (the targets at half
    the mixture's scale), held by ``enh_step_check``."""
    weights = chip_smoke.seeded_zoo("DPRNNTasNet", chip_smoke.ZOO_MODELS["DPRNNTasNet"],
                                    seed=0).state_dict()
    mix, tgt = chip_smoke.c12_test_batch((2, SR), (2, 2, SR))
    _held(chip_smoke.enh_step_check(chip_smoke.sep_train_fresh("dprnn", weights), mix, tgt,
                                    cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("stem", [s for s in chip_smoke.SEP_OPTIMIZERS if s != "dprnn"])
def test_separation_train_step_on_the_card(cuda_device, stem):
    """Each other separation config's step at full width on B=2 x 0.5 s of
    seeded noise, held by ``enh_step_check``."""
    name = chip_smoke.SEP_OPTIMIZERS[stem][0]
    weights = chip_smoke.seeded_zoo(name, chip_smoke.ZOO_MODELS[name], seed=0).state_dict()
    mix, tgt = chip_smoke.c12_test_batch((2, SR // 2), (2, 2, SR // 2))
    _held(chip_smoke.enh_step_check(chip_smoke.sep_train_fresh(stem, weights), mix, tgt,
                                    cuda_device))
