"""The port's train step against the JAX package's (``make_train_step`` over
optax), from the same weights carried across by ``bridge`` and the same
batches, on the CPU.

Tolerances:

* losses within rel 1e-5 (float32 convolutions summed in another order;
  measured 7e-7 over 3 steps);
* step 1's clipped gradients within 1e-5 · max|g| (measured 1e-7), the
  JAX side's read from Adam's first moment after the step;
* parameters after 3 steps within 1e-6 (measured 1.2e-7), except those
  whose gradient is float noise (max|g| < 1e-6 · max|g| over all; here the
  decoder's bias, whose gradient the zero-mean SNR cancels): Adam moves such
  a parameter by ±lr a step on the noise's sign, so they are held to
  2 · lr · steps;
* bf16: the JAX package's own bound (tests/test_train.py:177-206) on both
  sides, from the same weights.

The clip, the optimizer names and the PIT gradient are held to optax and
jax directly. A small-width DPRNN-TasNet is held the same way: an LSTM
model goes through the same train step unchanged, its ``bias_hh`` frozen so
the step moves the one bias per gate that flax's cell has.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sonicsim_tpu.models as JM
from sonicsim_tpu.losses import PairwiseNegSDR as JNegSDR
from sonicsim_tpu.losses import PITLossWrapper as JPIT
from sonicsim_tpu.train import make_optimizer as j_make_optimizer
from sonicsim_tpu.train import make_train_step as j_make_train_step
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch.losses import PairwiseNegSDR, PITLossWrapper
from sonicsim_tpu_torch.models import ConvTasNet, DPRNNTasNet
from sonicsim_tpu_torch.train import (Trainer, clip_by_global_norm, make_optimizer,
                                      make_train_step, set_learning_rate)
from sonicsim_tpu_torch.train.trainer import _val_shards
from torch_threads import one_intra_op_thread  # noqa: F401

CFG = dict(N=16, L=8, B=8, H=16, P=3, X=2, R=1, num_spks=2)
LR, CLIP, STEPS = 1e-3, 1.0, 3
LOSS_REL, GRAD_REL, PARAM_ATOL = 1e-5, 1e-5, 1e-6


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((4, 800)).astype(np.float32)
    tgt = rng.standard_normal((4, 2, 800)).astype(np.float32)
    return mix, tgt, _jax_init(CFG)


def _jax_init(cfg, n=800):
    """The JAX model's ``init_params(PRNGKey(0), n)``, jitted, as numpy."""
    init = jax.jit(JM.ConvTasNet(**cfg).init)
    return jax.tree.map(np.array, init(jax.random.PRNGKey(0), jnp.zeros((1, n), jnp.float32)))


def adam_mu(state):
    """The first-moment tree of the Adam inside the JAX factory's chain."""
    if hasattr(state, "mu"):
        return state.mu
    if hasattr(state, "inner_state"):
        return adam_mu(state.inner_state)
    if isinstance(state, (tuple, list)):
        for s in state:
            mu = adam_mu(s)
            if mu is not None:
                return mu
    return None


def _optax_steps(jm, j_loss, opt, p0, mix, tgt, steps=STEPS):
    """``steps`` of the JAX package's jitted train step: the parameters and
    optimizer state after them, the losses, and step 1's clipped gradients,
    read from Adam's first moment after step 1 (mu = (1 − b1) · g), so the
    step is the one function compiled."""
    j_step = jax.jit(j_make_train_step(jm, j_loss, opt))
    params, state, losses = p0, opt.init(p0), []
    for i in range(steps):
        params, state, val = j_step(params, state, jnp.asarray(mix), jnp.asarray(tgt))
        losses.append(float(val))
        if i == 0:
            clipped = jax.tree.map(lambda m: np.asarray(m) / 0.1, adam_mu(state))
    return params, state, losses, clipped


def _clip_fired(clipped, max_norm) -> bool:
    """optax's clip scales a norm above ``max_norm`` to ``max_norm`` and
    leaves one below it as it is: the clip fired where the clipped norm is
    the limit."""
    return abs(float(optax.global_norm(clipped)) - max_norm) <= 1e-4 * max_norm


def _unclipped_norm(model, loss, mix, tgt) -> float:
    """The global norm of ``model``'s step-1 gradients before any clip."""
    model.zero_grad()
    loss(model(torch.from_numpy(mix)), torch.from_numpy(tgt)).backward()
    norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.parameters()
                                if p.grad is not None)))
    model.zero_grad(set_to_none=True)
    return norm


def _port_model(params, cfg=CFG):
    model = ConvTasNet(**cfg, device="cpu")
    model.load_state_dict(bridge.convtasnet_state_dict(params))
    return model


def _pit(sdr_type="snr"):
    return (PITLossWrapper(PairwiseNegSDR(sdr_type), threshold_byloss=False),
            JPIT(JNegSDR(sdr_type), threshold_byloss=False))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])  # adam; adam with decay = adamw
def test_f32_step_matches_optax(setup, weight_decay):
    mix, tgt, p0 = setup
    loss, j_loss = _pit()
    jm = JM.ConvTasNet(**CFG)

    opt = j_make_optimizer(LR, weight_decay=weight_decay, clip_norm=CLIP)
    params, state, j_losses, j_clipped = _optax_steps(jm, j_loss, opt, p0, mix, tgt)
    assert _clip_fired(j_clipped, CLIP)

    model = _port_model(p0)
    assert _unclipped_norm(model, loss, mix, tgt) > 2 * CLIP
    step = make_train_step(model, loss, make_optimizer(model.parameters(), LR, weight_decay),
                           clip_norm=CLIP)
    losses = []
    for i in range(STEPS):
        losses.append(float(step(torch.from_numpy(mix), torch.from_numpy(tgt))))
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_REL)

    want = bridge.convtasnet_state_dict(jax.tree.map(np.array, j_clipped))
    g_max = max(float(g.abs().max()) for g in want.values())
    for name, g in grads.items():
        np.testing.assert_allclose(g, want[name], rtol=0, atol=GRAD_REL * g_max, err_msg=name)

    final = bridge.convtasnet_state_dict(jax.tree.map(np.array, params))
    noise = [n for n, g in want.items() if float(g.abs().max()) < 1e-6 * g_max]
    assert noise == ["decoder.decoder.bias"]
    for name, p in model.state_dict().items():
        atol = 2 * LR * STEPS if name in noise else PARAM_ATOL
        np.testing.assert_allclose(p, final[name], rtol=0, atol=atol, err_msg=name)
        assert p.dtype == torch.float32


DPRNN = dict(in_channels=32, out_channels=16, hidden_channels=16, K=20, num_layers=2)
DPRNN_CLIP = 0.1  # below its step-1 gradient norm (0.62), so the clip fires


def test_f32_step_matches_optax_dprnn(setup):
    """DPRNN-TasNet (dprnn.yaml's Adam, clip and PIT neg-SNR) at small width:
    the losses, step 1's clipped gradients and the parameters after 3 steps
    at the bounds above (the frozen ``bias_hh`` takes no gradient)."""
    mix, tgt, _ = setup
    # The loss is −SNR in dB, about 0 dB on the setup's targets, where a
    # relative bound is ill-posed; a tenth of them puts it near 20 dB.
    tgt = (0.1 * tgt).astype(np.float32)
    loss, j_loss = _pit()
    jm = JM.DPRNNTasNet(**DPRNN)
    p0 = jax.tree.map(np.array, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 800), jnp.float32)))
    opt = j_make_optimizer(LR, clip_norm=DPRNN_CLIP)
    params, state, j_losses, j_clipped = _optax_steps(jm, j_loss, opt, p0, mix, tgt)
    assert _clip_fired(j_clipped, DPRNN_CLIP)

    model = DPRNNTasNet(**DPRNN, device="cpu")
    model.load_state_dict(bridge.dprnn_state_dict(p0))
    assert _unclipped_norm(model, loss, mix, tgt) > 2 * DPRNN_CLIP
    step = make_train_step(model, loss, make_optimizer(model.parameters(), LR),
                           clip_norm=DPRNN_CLIP)
    losses = []
    for i in range(STEPS):
        losses.append(float(step(torch.from_numpy(mix), torch.from_numpy(tgt))))
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad}
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_REL)

    want = bridge.dprnn_state_dict(jax.tree.map(np.array, j_clipped))
    assert sorted(set(want) - set(grads)) == sorted(k for k in want if ".bias_hh_" in k)
    g_max = max(float(g.abs().max()) for g in want.values())
    for name, g in grads.items():
        np.testing.assert_allclose(g, want[name], rtol=0, atol=GRAD_REL * g_max, err_msg=name)

    # The noise rule above, element by element: an element whose step-1
    # gradient is float noise (|g| < 1e-6 · max|g|, here as small as Adam's
    # eps) is held to 2 · lr · steps, every other element to 1e-6.
    final = bridge.dprnn_state_dict(jax.tree.map(np.array, params))
    for name, p in model.state_dict().items():
        atol = torch.where(want[name].abs() < 1e-6 * g_max, 2 * LR * STEPS, PARAM_ATOL)
        err = (p - final[name]).abs()
        assert bool((err <= atol).all()), (name, float(err.max()))


def test_bf16_step_tracks_f32_on_both_sides(setup):
    """tests/test_train.py:177-206 on both packages from the same weights:
    6 steps on one batch, both precisions' losses fall, the first bf16 loss
    lies within 0.1·|f32| + 0.5 of the first f32 loss, master weights stay
    float32."""
    mix, tgt, _ = setup
    cfg = dict(CFG, X=1)
    p0 = _jax_init(cfg)
    loss, j_loss = _pit("sisdr")
    traces = {}
    for precision in ("f32", "bf16"):
        jm = JM.ConvTasNet(**cfg)
        opt = optax.adam(LR)
        j_step = jax.jit(j_make_train_step(jm, j_loss, opt, precision=precision))
        params, state, trace = p0, opt.init(p0), []
        for _ in range(6):
            params, state, val = j_step(params, state, jnp.asarray(mix), jnp.asarray(tgt))
            trace.append(float(val))
        traces["jax", precision] = trace

        model = _port_model(p0, cfg)
        step = make_train_step(model, loss, make_optimizer(model.parameters(), LR),
                               precision=precision, clip_norm=None)
        traces["port", precision] = [float(step(torch.from_numpy(mix), torch.from_numpy(tgt)))
                                     for _ in range(6)]
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    for side in ("jax", "port"):
        f32, bf16 = traces[side, "f32"], traces[side, "bf16"]
        for tr in (f32, bf16):
            assert np.isfinite(tr).all() and tr[-1] < tr[0]
        assert abs(bf16[0] - f32[0]) < 0.1 * abs(f32[0]) + 0.5
    assert abs(traces["port", "bf16"][0] - traces["jax", "f32"][0]) < (
        0.1 * abs(traces["jax", "f32"][0]) + 0.5)


def test_clip_by_global_norm_is_optax():
    rng = np.random.default_rng(3)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,), (2, 2, 2))]
    norm = float(np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2)) for x in leaves)))
    for max_norm in (0.5 * norm, norm * (1 + 1e-6), 2.0 * norm):
        grads = [torch.from_numpy(x.copy()) for x in leaves]
        g_norm = clip_by_global_norm(grads, max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(x) for x in leaves], None)
        assert float(g_norm) == pytest.approx(norm, rel=1e-6)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
        if max_norm > norm:  # below the threshold the gradients pass unchanged
            assert all(np.array_equal(g.numpy(), x) for g, x in zip(grads, leaves))


def test_make_optimizer_maps_the_jax_factory():
    p = [torch.nn.Parameter(torch.zeros(3))]
    adam = make_optimizer(p, 2e-3)
    assert type(adam) is torch.optim.Adam
    assert adam.defaults["betas"] == (0.9, 0.999) and adam.defaults["eps"] == 1e-8
    assert type(make_optimizer(p, name="Adam", weight_decay=0.1)) is torch.optim.AdamW
    assert make_optimizer(p, weight_decay=0.1).defaults["weight_decay"] == 0.1
    # optax.adamw's own default decay where the config sets none
    assert make_optimizer(p, name="adamw").defaults["weight_decay"] == 1e-4
    sgd = make_optimizer(p, name="sgd")  # optax.sgd: no momentum, no decay by default
    assert type(sgd).__name__ == "SGD" and not isinstance(sgd, torch.optim.SGD)
    assert sgd.defaults == dict(lr=1e-3, momentum=None, nesterov=False)
    with pytest.raises(KeyError):
        make_optimizer(p, name="nope")
    set_learning_rate(adam, 5e-4)
    assert [g["lr"] for g in adam.param_groups] == [5e-4]


def test_pit_gradient_on_tied_permutations_is_jax():
    """The chosen permutation's gradient, and on an exact tie the same split
    over the tied permutations as ``jax.grad`` of ``jnp.min``."""
    rng = np.random.default_rng(4)
    tgt = rng.standard_normal((2, 2, 64)).astype(np.float32)
    ests = rng.standard_normal((2, 2, 64)).astype(np.float32)
    ests[1] = tgt[1, [0, 0]]  # item 1: both estimates equal target 0 → a tie
    loss, j_loss = _pit()
    x = torch.from_numpy(ests).requires_grad_()
    loss(x, torch.from_numpy(tgt)).backward()
    want = jax.jit(jax.grad(lambda e: j_loss(e, tgt)))(jnp.asarray(ests))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_val_shards_exact_and_bounded():
    """``_val_shards``' weighted recombination equals the plain per-item
    mean, every shard divides by the divisor, and the padding stays below
    divisor² (the JAX package's test, on the port's copy; the trainer uses
    divisor 1)."""
    rng = np.random.default_rng(0)
    for b, d in [(31, 8), (7, 8), (8, 8), (9, 8), (16, 8), (1, 8), (13, 4), (5, 1)]:
        mix = rng.standard_normal((b, 32)).astype(np.float32)
        tgt = rng.standard_normal((b, 2, 32)).astype(np.float32)
        total, n, padded = 0.0, 0, 0
        for ms, ts, w in _val_shards(mix, tgt, d):
            assert len(ms) % d == 0 and len(ms) == len(ts)
            padded += len(ms)
            total += float(np.mean([np.square(m).mean() for m in ms])) * w
            n += w
        assert n == b
        assert abs(total / n - float(np.mean([np.square(m).mean() for m in mix]))) < 1e-6
        assert padded - b < d * d


def test_trainer_val_loss_weighted_mean():
    rng = np.random.default_rng(1)
    batches = [(rng.standard_normal((b, 16)).astype(np.float32),
                rng.standard_normal((b, 2, 16)).astype(np.float32)) for b in (5, 3)]

    def eval_step(m, t):  # a batch-mean metric, as make_eval_step's
        return m.square().mean(dim=tuple(range(1, m.ndim))).mean()

    trainer = Trainer(model=None, loss_fn=None)
    got = trainer._val_loss(eval_step, iter(batches), torch.device("cpu"))
    every = np.concatenate([m for m, _ in batches], axis=0)
    assert abs(got - float(np.mean([np.square(m).mean() for m in every]))) < 1e-6
    assert trainer._val_loss(eval_step, iter(()), torch.device("cpu")) is None
