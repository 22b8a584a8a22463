"""The device mesh on the card: chunked inference and the data-parallel
train step over two replicas of ``cuda:0`` (``chip_smoke.py`` phase 20's
checks (d) and (e) at small widths), each against the unsharded call on the
card, from torch's seeded weights.

Tolerances: chunked inference within 1e-5 · max|ref| of the unsharded call
at ``batch_size`` x 2 (DCCRN's batch statistics over every window of a
call); the train step's gradients in float64 within 1e-9 · max|g64| of the
unsharded step over the whole tree, in float32 within max(1e-4, 2 x the
unsharded float32 step's largest distance over three roundings of its
function: the batch in order, reversed, each item twice) · max|g64| of the
unsharded float64 step (``chip_smoke.py`` phase 14's rule). The step with
per-shard statistics (each shard through the unsharded model) must miss
that float32 bound for DCCRN and FRCRN, the batch-statistics models.

These tests import neither jax nor the JAX package and use no conftest
fixture, so they run on the card alone:
``python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py``.
"""

import copy

import numpy as np
import pytest
import torch

from sonicsim_tpu_torch import losses as TL
from sonicsim_tpu_torch.infer import wav_chunk_inference
from sonicsim_tpu_torch.models import DCCRN, FRCRN, ConvTasNet
from sonicsim_tpu_torch.parallel import Mesh, gather
from sonicsim_tpu_torch.scripts.common import strict_float32
from sonicsim_tpu_torch.train import make_optimizer, make_train_step

SR = 16000
CHUNK_REL = 1e-5
F64_REL, GRAD_REL, ILL_FACTOR = 1e-9, 1e-4, 2
CTN = dict(N=64, L=16, B=32, H=64, P=3, X=2, R=2, num_spks=2)
DCCRN_SMALL = dict(rnn_units=32, kernel_num=(8, 16, 32), rnn_layers=2)


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh's card run")
    strict_float32()
    return Mesh(["cuda:0", "cuda:0"])


def _model(name):
    torch.manual_seed(0)
    if name == "ConvTasNet":
        return ConvTasNet(**CTN, device="cuda")
    if name == "DCCRN":
        return DCCRN(**DCCRN_SMALL, device="cuda")
    return FRCRN(device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,n_tracks", [("ConvTasNet", 2), ("DCCRN", 1)])
def test_chunked_inference_over_two_replicas(mesh, name, n_tracks):
    model = _model(name).eval()
    x = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal(10 * SR))
                         .astype(np.float32)).cuda()
    kw = dict(sample_rate=SR, target_length=2.0, hop_length=1.0, n_tracks=n_tracks)
    want = wav_chunk_inference(model, x, batch_size=6, **kw)
    got = wav_chunk_inference(model, x, batch_size=3, mesh=mesh, **kw)
    assert got.shape == want.shape and got.device == want.device
    ref = float(want.abs().max())
    assert float((got - want).abs().max()) <= CHUNK_REL * ref


class _PerShard(torch.nn.Module):
    """Each of ``n`` shards through the unsharded model, the outputs
    gathered: the per-shard-statistics step a mesh step must not be."""

    def __init__(self, inner, n):
        super().__init__()
        self.inner, self.n = inner, n

    def forward(self, x):
        return gather([self.inner(s) for s in x.tensor_split(self.n)], x.device)


def _grads(model, loss_fn, x, y, mesh, shards=0):
    step = make_train_step(_PerShard(model, shards) if shards else model, loss_fn,
                           make_optimizer(model.parameters(), 1e-3), clip_norm=5.0, mesh=mesh)
    step(x, y)
    return {n: p.grad.detach().double() for n, p in model.named_parameters() if p.grad is not None}


def _dist(a, b):
    g_max = max(float(g.abs().max()) for g in b.values())
    return max(float((a[n] - g).abs().max()) for n, g in b.items()) / g_max


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ConvTasNet", "DCCRN", "FRCRN"])
def test_data_parallel_step_over_two_replicas(mesh, name):
    rng = np.random.default_rng(1)
    n = SR // 2
    mix = torch.from_numpy((0.3 * rng.standard_normal((4, n))).astype(np.float32)).cuda()
    if name == "ConvTasNet":
        tgt = torch.from_numpy((0.3 * rng.standard_normal((4, 2, n))).astype(np.float32)).cuda()
        loss_fn = TL.PITLossWrapper(TL.PairwiseNegSDR("snr"), threshold_byloss=True)
    else:
        tgt = mix + 0.1 * torch.from_numpy(rng.standard_normal((4, n)).astype(np.float32)).cuda()
        loss_fn = TL.DCCRNLoss() if name == "DCCRN" else TL.FRCRNLoss()
    base = _model(name).train()
    g = {}
    for dtype in (torch.float64, torch.float32):
        for label, m in (("one", None), ("mesh", mesh)):
            g[dtype, label] = _grads(copy.deepcopy(base).to(dtype), loss_fn, mix.to(dtype),
                                     tgt.to(dtype), m)
    g["reversed"] = _grads(copy.deepcopy(base), loss_fn, mix.flip(0), tgt.flip(0), None)
    g["doubled"] = _grads(copy.deepcopy(base), loss_fn, torch.cat([mix, mix]),
                          torch.cat([tgt, tgt]), None)
    g64 = g[torch.float64, "one"]
    assert _dist(g[torch.float64, "mesh"], g64) <= F64_REL
    spread = max(_dist(g[k], g64) for k in ((torch.float32, "one"), "reversed", "doubled"))
    bound = max(GRAD_REL, ILL_FACTOR * spread)
    assert _dist(g[torch.float32, "mesh"], g64) <= bound
    if name != "ConvTasNet":  # no batch statistics, no per-shard function to miss
        per_shard = _grads(copy.deepcopy(base), loss_fn, mix, tgt, None, mesh.size)
        assert _dist(per_shard, g64) > bound
