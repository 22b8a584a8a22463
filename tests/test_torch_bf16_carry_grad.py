"""bf16 training through the float32-carry LSTMs in the port
(``ops.lstm_cell.f32_carry_lstm``), on the CPU, against the JAX package.

flax's ``nn.RNN(OptimizedLSTMCell)`` keeps a float32 carry, and the JAX
``make_train_step(precision="bf16")`` casts the parameters to bfloat16
inside the traced function, so each step of the scan casts them up again.
The compiled HLO of ``jax.vjp`` then carries each weight's and bias's
gradient as a bfloat16 running sum over the steps: ``dW = rnd(dW +
rnd(P_t))``, ``P_t`` the float32 product ``dz_tᵀ·h_{t−1}`` (``dz_tᵀ·x_t`` on a
float32 input, ``rnd(dz_t)ᵀ·x_t`` on a bfloat16 one, whose input dense is
bfloat16), and the bias's ``rnd(s_t)``, ``s_t`` the float32 row sum of
``dz_t`` in XLA's windows of 32 rows. cuDNN's recurrence sums the same
products in float32 and rounds once.

* (a) one layer: the port's cotangents (x, W_ih, W_hh, bias, h0, c0)
  against ``jax.vjp`` of a float32-carry flax cell on bfloat16 parameters
  from the same numpy inputs, 6 and 70 rows (70 takes XLA's windowed row
  sum), uni- and bidirectional, on a bfloat16 and a float32 input. The
  weight and bias leaves within ``REL`` and x's on a bfloat16 input within
  ``X_REL``, 3x the readings (most are bit-equal); the float32 sum (cuDNN's
  own weight gradients, ``zoo_layers._trains_bf16_weights`` patched off)
  misses ``REL``. The float32 cotangents (h0, c0, x on a float32 input)
  sit within ``F32_REL``. The same gradients walked in chunks of 5 steps
  (``lstm_cell.PRODUCTS_BUDGET`` cut) are bit-equal to the unchunked
  ones.
* (b) one bf16 train step of DPRNN, SkiM (``mem_type`` "hc", non-causal
  and causal) and DCCRN, the port's ``make_train_step(precision="bf16")``
  against ``jax.grad`` of the JAX ``make_train_step``'s bf16 loss from
  seeded weights carried by the bridge: every float32-carry LSTM leaf
  (rel-L2 a leaf) within ``MODEL_BOUND``, 3x the readings and below 1e-2;
  with the float32 sum the worst leaf misses it. DPRNN's and DCCRN's other
  leaves too (rel-L2 a leaf) within ``REST_BOUND``, 3x the readings;
  DCCRN's convolution biases before a batch norm, whose gradients are zero
  but for rounding (norms near 1e-5 against leaves near 1e2), by their
  distance over the largest leaf's norm, within ``ZERO_BOUND``, 3x the
  reading.

Widths: the zoo tests' small models (SkiM with 16 units), 0.25 s of audio
(B=2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as nn
import sonicsim_tpu.models as JM
from sonicsim_tpu.train import make_train_step as j_make_train_step
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch.models import zoo_layers
from sonicsim_tpu_torch.ops import lstm_cell
from sonicsim_tpu_torch.train import make_train_step

from test_torch_bf16_cell_grad import _grab, bf16, f32, rel_l2
from test_torch_bf16_enh import _losses as enh_losses
from test_torch_bf16_sep import batch
from test_torch_enh_models import SMALL as ENH_SMALL
from test_torch_sep_train import _pit, _seeded
from test_torch_skim import SMALL as SKIM_SMALL
from test_torch_variants import _flax_leaves, _params
from test_torch_zoo_models import SMALL as ZOO_SMALL
from torch_threads import one_intra_op_thread  # noqa: F401

K, C, H = 12, 8, 16
# 3x the readings: the weight and bias leaves 0 to 1.73e-4, x on a bfloat16
# input 0 to 2.47e-5; the float32 sums read 3.15e-3 to 7.37e-3 on the weights.
REL = 5.2e-4
X_REL = 7.5e-5
F32_REL = 1e-5
T = 4000
NAMES = ("x", "W_ih", "W_hh", "bias", "h0", "c0")


def jax_carry_vjp(x, w_ih, w_hh, bias, h0, c0, dy, dhn, dcn, x_dtype):
    """``jax.vjp`` of flax's ``nn.RNN(OptimizedLSTMCell)`` with a float32
    carry over D directions (direction 1 on ``x`` reversed), the parameters
    float32 and cast to bfloat16 inside, ``x`` in ``x_dtype``: the
    cotangents of ``x``, each direction's ``(W_ih, W_hh, bias)`` in torch's
    layout and of ``h0``, ``c0``, float32 numpy."""
    dirs, hidden = w_hh.shape[0], w_hh.shape[2]
    rnn = nn.RNN(nn.OptimizedLSTMCell(hidden))
    trees = [bridge._cell_to_flax({"l.weight_ih_l0": w_ih[d], "l.weight_hh_l0": w_hh[d],
                                   "l.bias_ih_l0": bias[d], "l.bias_hh_l0": 0 * bias[d]},
                                  "l", "l0") for d in range(dirs)]

    def run(ps, xx, h, c):
        outs, hs, cs = [], [], []
        for d, p in enumerate(ps):
            p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
            xd = xx[:, ::-1] if d else xx
            (cn, hn), y = rnn.apply({"params": {"cell": p}}, xd, initial_carry=(c[d], h[d]),
                                    return_carry=True)
            outs.append(y[:, ::-1] if d else y)
            hs.append(hn)
            cs.append(cn)
        return jnp.concatenate(outs, -1), jnp.stack(hs), jnp.stack(cs)

    f = (lambda a: jnp.asarray(a, jnp.float32))
    _, vjp = jax.vjp(run, [jax.tree.map(jnp.asarray, t) for t in trees],
                     jnp.asarray(x, x_dtype), f(h0), f(c0))
    gp, gx, gh, gc = jax.jit(vjp)((f(dy), f(dhn), f(dcn)))
    torch_layout = [bridge._cell_to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32), g),
                                          "l", "l0") for g in gp]
    weights = [np.stack([t[f"l.{n}_l0"] for t in torch_layout])
               for n in ("weight_ih", "weight_hh", "bias_ih")]
    return [np.asarray(a, np.float32) for a in (gx, *weights, gh, gc)]


def port_carry_grads(args, cotangents, x_dtype):
    """The port's cotangents of (x, W_ih, W_hh, bias, h0, c0) through an
    ``LSTMLayer`` on the bfloat16 weights (the train step's route), float32
    numpy."""
    x = torch.from_numpy(args[0]).to(x_dtype).requires_grad_()
    w_ih, w_hh, bias = (bf16(a).requires_grad_() for a in args[1:4])
    h0, c0 = (torch.from_numpy(a).requires_grad_() for a in args[4:])
    dirs = w_hh.shape[0]
    layer = zoo_layers.LSTMLayer(x.shape[-1], w_hh.shape[2], bidirectional=dirs == 2)
    state = {}
    for d, sfx in enumerate(("l0", "l0_reverse")[:dirs]):
        state |= {f"weight_ih_{sfx}": w_ih[d], f"weight_hh_{sfx}": w_hh[d],
                  f"bias_ih_{sfx}": bias[d], f"bias_hh_{sfx}": torch.zeros_like(bias[d])}
    y, (h, c) = _run(layer, state, x, h0, c0)
    torch.autograd.backward((y, h, c), tuple(torch.from_numpy(a) for a in cotangents))
    return [f32(t.grad) for t in (x, w_ih, w_hh, bias, h0, c0)]


def _run(layer, state, x, h0, c0):
    class Call(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layer = layer

        def forward(self, v):
            return self.layer.run(v, (h0, c0))

    return torch.func.functional_call(Call(), {f"layer.{k}": v for k, v in state.items()},
                                      (x,))


def inputs(n, dirs, seed):
    rng = np.random.default_rng(seed)

    def draw(shape, scale=1.0):
        return np.asarray(bf16(scale * rng.standard_normal(shape)).float())

    args = [draw((n, K, C)), draw((dirs, 4 * H, C), 0.3), draw((dirs, 4 * H, H), 0.3),
            draw((dirs, 4 * H), 0.3), np.tanh(draw((dirs, n, H))), draw((dirs, n, H))]
    cts = [draw((n, K, dirs * H)), draw((dirs, n, H)), draw((dirs, n, H))]
    return args, cts


CASES = [(n, dirs, xd) for n in (6, 70) for dirs in (1, 2) for xd in ("bf16", "f32")]


@pytest.mark.parametrize("n,dirs,xd", CASES, ids=[f"{n}rows-{'bi' if d == 2 else 'uni'}-{x}in"
                                                   for n, d, x in CASES])
def test_layer_gradients_are_jax_vjp(n, dirs, xd, monkeypatch):
    x_dtype = torch.bfloat16 if xd == "bf16" else torch.float32
    args, cts = inputs(n, dirs, 7 * n + dirs + (xd == "f32"))
    want = jax_carry_vjp(*args, *cts, jnp.bfloat16 if xd == "bf16" else jnp.float32)
    got = port_carry_grads(args, cts, x_dtype)
    dists = {k: rel_l2(g, w) for k, g, w in zip(NAMES, got, want)}
    print("rel-L2:", dists)
    assert max(dists[k] for k in NAMES[1:4]) <= REL, dists
    assert max(dists[k] for k in ("h0", "c0")) <= F32_REL, dists
    assert dists["x"] <= (X_REL if xd == "bf16" else F32_REL), dists
    # Walked in chunks of 5 steps: the same bits.
    per_step = 4 * dirs * 4 * H * (H + C)
    monkeypatch.setattr(lstm_cell, "PRODUCTS_BUDGET", 5 * per_step)
    chunked = port_carry_grads(args, cts, x_dtype)
    assert all(np.array_equal(a, b) for a, b in zip(chunked, got))
    # cuDNN's float32 sums miss the bound.
    monkeypatch.setattr(zoo_layers, "_trains_bf16_weights", lambda run, weights: False)
    old = {k: rel_l2(g, w) for k, g, w in zip(NAMES, port_carry_grads(args, cts, x_dtype),
                                             want)}
    print("float32 sums rel-L2:", old)
    assert max(old[k] for k in NAMES[1:4]) > REL, old


# Model case → (model, small width, loss family).
MODELS = {
    "dprnn": ("DPRNNTasNet", ZOO_SMALL["DPRNNTasNet"], "pit"),
    "skim-hc": ("SkiMNet", dict(SKIM_SMALL, unit=H, causal=False, seg_overlap=True,
                                mem_type="hc"), "pit"),
    "skim-causal": ("SkiMNet", dict(SKIM_SMALL, unit=H, causal=True, seg_overlap=False,
                                    mem_type="hc"), "pit"),
    "dccrn": ("DCCRN", ENH_SMALL["DCCRN"], "dccrn"),
}
# 3x the readings (2.118e-3, 2.629e-3, 2.129e-4, 2.620e-3); the float32 sums read
# 1.682e-2, 6.605e-2, 4.830e-2 and 1.296e-2.
MODEL_BOUND = {"dprnn": 6.4e-3, "skim-hc": 7.9e-3, "skim-causal": 6.4e-4, "dccrn": 7.9e-3}
# The other leaves: 3x the readings (DPRNN 2.366e-3 at encoder/kernel,
# DCCRN 3.436e-3 at dec_prelu_0); DCCRN's 10 leaves whose gradient is zero
# but for rounding (below 1e-4 of the largest leaf's norm), 3x their largest
# distance over that norm (2.017e-7). The repair of SkiM's Dense and norm
# (layers.dense_norm_bf16) is not on these models' paths: the readings are
# the parent's.
REST_BOUND = {"dprnn": 7.1e-3, "dccrn": 1.04e-2}
ZERO_BOUND = {"dprnn": 0.0, "dccrn": 6.1e-7}
ZERO_SHARE = 1e-4


def _step_grads(name, cfg, loss, mix, tgt) -> list:
    """The port's bf16 step with a zero learning rate: its gradients in
    the flax layout."""
    model, _ = _seeded(name, cfg)
    step = make_train_step(model, loss, torch.optim.SGD(model.parameters(), lr=0.0),
                           precision="bf16", clip_norm=None)
    step(torch.from_numpy(mix), torch.from_numpy(tgt))
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return [np.asarray(a) for a in _flax_leaves(name, model, grads)]


@pytest.mark.parametrize("case", list(MODELS))
def test_bf16_step_float32_carry_leaves_are_jax(case, monkeypatch):
    name, cfg, family = MODELS[case]
    loss, j_loss = _pit() if family == "pit" else enh_losses(family)[::-1]
    mix, tgt = batch(2 if family == "pit" else 1)
    _, params = _seeded(name, cfg)
    step = jax.jit(j_make_train_step(JM.get(name)(**cfg), j_loss, _grab(), precision="bf16"))
    _, j_grads, _ = step(params, _grab().init(params), jnp.asarray(mix), jnp.asarray(tgt))
    want = [np.asarray(a, np.float32) for a in _params(j_grads)]
    names = ["/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(params["params"])[0]]
    # The float32-carry LSTM leaves: every LSTM cell's but SkiM's first
    # SegLSTM's, whose carry is bfloat16 (tests/test_torch_bf16_cell_grad.py).
    carry = [i for i, nm in enumerate(names)
             if "OptimizedLSTMCell" in nm and not nm.startswith("seg_lstm_0/")]
    assert carry
    got = _step_grads(name, cfg, loss, mix, tgt)
    dists = {names[i]: rel_l2(got[i], want[i]) for i in carry}
    worst = max(dists.values())
    monkeypatch.setattr(zoo_layers, "_trains_bf16_weights", lambda run, weights: False)
    before = _step_grads(name, cfg, loss, mix, tgt)
    old = max(rel_l2(before[i], want[i]) for i in carry)
    print(f"{case}: {len(carry)} float32-carry leaves, worst rel-L2 {worst:.3e} "
          f"(float32 sums {old:.3e})", sorted(dists.items(), key=lambda kv: -kv[1])[:3])
    assert worst <= MODEL_BOUND[case] < old, (worst, old)
    if case in REST_BOUND:
        scale = max(np.linalg.norm(w) for w in want)
        other = [i for i, nm in enumerate(names) if "OptimizedLSTMCell" not in nm]
        zero = [i for i in other if np.linalg.norm(want[i]) < ZERO_SHARE * scale]
        rest = max((rel_l2(got[i], want[i]), names[i]) for i in other if i not in zero)
        off = max((float(np.linalg.norm(got[i] - want[i]) / scale) for i in zero), default=0.0)
        print(f"{case}: {len(other)} other leaves, worst rel-L2 {rest[0]:.3e} ({rest[1]}); "
              f"{len(zero)} zero but for rounding, distance over the largest leaf {off:.3e}")
        assert rest[0] <= REST_BOUND[case] and off <= ZERO_BOUND[case], (rest, off)
