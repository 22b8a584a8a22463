"""The optimizer zoo on the card: chip_smoke.py's phase 19 (a) check, one
optax name per case. Three steps of seeded float64 gradients over DPTNet's
full-width parameters at two of its six layers (convolutions, LSTMs with a
frozen ``bias_hh``, MHA split into query, key and value leaves), the clip
firing on the second and
the LR changed after the first: the card in float64 within
``OPT_F64_REL`` (1e-9) · max|Δp64| of the CPU in float64, in float32 within
max(``OPT_F32_REL`` (1e-5), ``ILL_FACTOR`` times the CPU's float32 distance
from float64) · max|Δp64|.

These tests import neither jax nor the JAX package and use no conftest
fixture, so they run on the card alone:
``python -m pytest --noconftest -m cuda tests/test_torch_optim_cuda.py``.
"""

import pytest
import torch

import chip_smoke
from sonicsim_tpu_torch.scripts.common import strict_float32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the optimizer zoo on the card")
    strict_float32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.OPTIM_NAMES)
def test_optimizer_on_the_card(cuda_device, name):
    stats = chip_smoke.phase_optim_zoo(cuda_device, dict(chip_smoke.ADAPTERS, names=[name]), "")
    assert stats[name]["f64"] <= chip_smoke.OPT_F64_REL
