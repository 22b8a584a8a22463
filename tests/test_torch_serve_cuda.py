"""ConvTasNet serving on the card, held against the port on the CPU with the
same weights: the full-width forward in float32 and bfloat16, and the
tracker's SDRs.

Tolerances: float32 within 1e-4 · max|ref| (TF32 off; cuDNN sums in
another order); bfloat16 within rel-L2 0.05 of float32 (the JAX package's
bound); SI-SNR within 1e-3 dB and SDR within 1e-2 dB.

These tests import neither jax nor the JAX package and use no conftest
fixture, so they run on the card alone:
``python -m pytest --noconftest -m cuda tests/test_torch_serve_cuda.py``.
"""

import numpy as np
import pytest
import torch

from sonicsim_tpu_torch.infer import bf16_forward
from sonicsim_tpu_torch.metrics import MetricsTracker
from sonicsim_tpu_torch.models import ConvTasNet
from sonicsim_tpu_torch.scripts.common import strict_float32

SR = 16000
FULL = dict(N=512, L=32, B=128, H=512, P=3, X=8, R=3, norm="gLN", num_spks=2,
            activate="relu", causal=False, sample_rate=SR)  # convtasnet.yaml


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the serving path's card run")
    strict_float32()
    return torch.device("cuda")


def _pair(device):
    torch.manual_seed(0)
    cpu = ConvTasNet(**FULL, device="cpu").eval()
    card = ConvTasNet(**FULL, device=device).eval()
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.cuda
def test_convtasnet_on_card_matches_cpu(cuda_device):
    cpu, card = _pair(cuda_device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4 * SR)).astype(np.float32))
    with torch.inference_mode():
        ref = cpu(x)
        got = card(x.to(cuda_device))
        got16 = bf16_forward(card)(x.to(cuda_device))
    assert got.shape == ref.shape == (2, 2, 4 * SR) and torch.isfinite(got).all()
    err = float((got.cpu() - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max())
    assert float((got16 - got).norm() / got.norm()) < 0.05


@pytest.mark.cuda
def test_tracker_on_card_matches_cpu(cuda_device, tmp_path):
    rng = np.random.default_rng(1)
    clean = rng.standard_normal((2, 2 * SR)).astype(np.float32)
    est = (clean[::-1] + 0.5 * rng.standard_normal((2, 2 * SR))).astype(np.float32)
    rows = {}
    for name, device in (("cpu", "cpu"), ("card", cuda_device)):
        tracker = MetricsTracker(tmp_path / f"{name}.csv", device=device)
        tracker(clean.sum(0), clean, est, "seg")
        rows[name] = tracker.rows[0]
    assert abs(rows["card"]["si-snr"] - rows["cpu"]["si-snr"]) <= 1e-3
    assert abs(rows["card"]["sdr"] - rows["cpu"]["sdr"]) <= 1e-2
