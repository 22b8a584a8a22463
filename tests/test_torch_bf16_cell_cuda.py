"""The bf16 LSTM cell kernel (``csrc/bf16_lstm.cu``) on the card against its
plain version (``ops.lstm_cell.bf16_lstm_scan_ref``) on the same card.

* at a small shape (6 rows, 24 steps, 32 units), both directions, from a
  zero and from a seeded carry, and every hidden width the kernel has an
  instance of, uni- and bidirectional;
* at SkiM's full shape (642 rows, 250 steps, 128 units, two directions: the
  first SegLSTM of skim.yaml on 10 s of audio), from the inputs the model's
  bf16 forward gives the kernel and from injected carries;
* a failed build raises, and so does a width the kernel has no instance of.

Tolerance rel-L2 1e-3 (``chip_smoke.py`` phase 22's): the kernel's dot runs
on the tensor cores in another summation order than the plain version's
float32 matmul, and a bfloat16 rounding that flips carries through the
recurrence. Imports neither jax nor the JAX package (the card's host has
neither); run with ``--noconftest``.
"""

import numpy as np
import pytest
import torch

from sonicsim_tpu_torch.ops import lstm_cell

REL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16 LSTM cell kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def inputs(n, k, h, dirs, seed, carry, device):
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, torch.bfloat16)

    xp = bf(rng.standard_normal((n, k, dirs * 4 * h)))
    w_hh = bf(rng.standard_normal((dirs, 4 * h, h)) / np.sqrt(h))
    bias = bf(0.1 * rng.standard_normal((dirs, 4 * h)))
    if carry:
        h0, c0 = bf(np.tanh(rng.standard_normal((dirs, n, h)))), bf(rng.standard_normal((dirs, n, h)))
    else:
        h0 = c0 = bf(np.zeros((dirs, n, h)))
    return xp, w_hh, bias, h0, c0, [d == 1 for d in range(dirs)]


def hold(args) -> list:
    before = lstm_cell.LAUNCHES["bf16_lstm_scan"]
    got = lstm_cell.bf16_lstm_scan(*args)
    torch.cuda.synchronize()
    assert lstm_cell.LAUNCHES["bf16_lstm_scan"] == before + 1
    ref = lstm_cell.bf16_lstm_scan_ref(*args)
    assert all(g.dtype == torch.bfloat16 and g.shape == r.shape for g, r in zip(got, ref))
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)
    return [rel_l2(g, r) for g, r in zip(got, ref)]


@pytest.mark.cuda
@pytest.mark.parametrize("carry", [False, True], ids=["zero", "seeded"])
@pytest.mark.parametrize("dirs", [1, 2])
def test_kernel_matches_plain_small(cuda_device, dirs, carry):
    dists = hold(inputs(6, 24, 32, dirs, 3 + dirs, carry, cuda_device))
    assert max(dists) <= REL, dists


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", lstm_cell.HIDDEN)
def test_every_hidden_width(cuda_device, hidden):
    dists = hold(inputs(21, 9, hidden, 2, hidden, True, cuda_device))
    assert max(dists) <= REL, dists


def skim_inputs(device) -> tuple:
    """The kernel's arguments in skim.yaml's bf16 forward of 10 s of seeded
    noise on the card (``chip_smoke.seeded_zoo``'s weights)."""
    import chip_smoke
    from sonicsim_tpu_torch.models import zoo_layers
    from sonicsim_tpu_torch.scripts.common import make_forward

    model = chip_smoke.seeded_zoo("SkiMNet", chip_smoke.ZOO_MODELS["SkiMNet"], 0).to(device)
    seen, scan = [], zoo_layers.bf16_lstm_scan

    def record(*args):
        seen.append(args)
        return scan(*args)

    zoo_layers.bf16_lstm_scan = record
    try:
        x = 0.1 * torch.randn(1, 160000, generator=torch.Generator().manual_seed(0))
        make_forward(model, bf16=True)(x.to(device))
    finally:
        zoo_layers.bf16_lstm_scan = scan
    assert len(seen) == 1  # skim.yaml: the first SegLSTM alone has a bfloat16 carry
    return seen[0]


@pytest.mark.cuda
@pytest.mark.parametrize("carry", ["model", "injected"])
def test_kernel_matches_plain_at_skim_shape(cuda_device, carry):
    xp, w_hh, bias, h0, c0, reverse = skim_inputs(cuda_device)
    assert tuple(xp.shape) == (642, 250, 1024) and tuple(w_hh.shape) == (2, 512, 128)
    if carry == "injected":
        g = torch.Generator(device=cuda_device).manual_seed(1)
        h0 = torch.tanh(torch.randn(h0.shape, generator=g, device=cuda_device)).bfloat16()
        c0 = torch.randn(c0.shape, generator=g, device=cuda_device).bfloat16()
    dists = hold((xp, w_hh, bias, h0, c0, reverse))
    assert max(dists) <= REL, dists


@pytest.mark.cuda
def test_failed_build_and_unbuilt_width_raise(cuda_device, tmp_path, monkeypatch):
    args = inputs(4, 3, 32, 1, 0, False, cuda_device)
    with pytest.raises(ValueError, match="hidden width"):
        lstm_cell.bf16_lstm_scan(*inputs(4, 3, 24, 1, 0, False, cuda_device))
    bad = tmp_path / "bf16_lstm.cu"
    bad.write_text(lstm_cell.SOURCE.read_text() + "\nthis does not compile;\n")
    monkeypatch.setattr(lstm_cell, "SOURCE", bad)
    monkeypatch.setattr(lstm_cell, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        lstm_cell.bf16_lstm_scan(*args)
