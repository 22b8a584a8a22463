"""Training through flax's bfloat16 LSTM cell in the port
(``ops.lstm_cell.bf16_lstm``), on the CPU, against the JAX package.

The JAX scan's VJP, as XLA compiles ``jax.vjp`` of a bfloat16
``nn.RNN(OptimizedLSTMCell)`` whose parameters are cast to bfloat16 inside
the function (``make_train_step(precision="bf16")``'s form), rounds every op
of the cell's VJP, carries each weight's and bias's gradient as a
bfloat16 running sum over the steps, and sums each step's bias gradient
over the rows with a rounding reducer in windows of 32 rows
(``bf16_lstm_scan_backward_ref``, ``step_products``,
``bf16_running_sum_ref``, ``row_sum_ref``):

* (a) the port's gradients (``bf16_lstm``'s autograd Function, the plain
  versions on the CPU) against ``jax.vjp`` of flax's bf16 cell from the
  same numpy inputs and cotangents: every cotangent (x, W_ih, W_hh, bias,
  h0, c0), uni- and bidirectional (the JAX SegLSTM's two ``nn.RNN``s on
  ``x`` and ``x`` reversed), zero and seeded carries, 6 and 70 rows (70
  takes XLA's windowed row sum). Readings: 0 (bit-equal) on every
  cotangent at 6 rows; at 70 rows up to 1.10e-3, where a float32 dot summed
  in another order than XLA's flips a rounding and the recurrence carries
  it on. Bound rel-L2 ``REL`` = 3.3e-3, 3x the readings. The float32
  recurrence the port trained through before (cuDNN's function on the
  rounded projection, ``zoo_layers._wide_recurrence``) misses it (its
  readings 5.96e-3 to 1.16e-2);
* (b) SkiM's bf16 train step (skim.yaml's mode, ``mem_type`` "id", where
  every block's SegLSTM carries bfloat16, and skim.yaml's "hc", where the
  first does; and causal) through the port's ``make_train_step(precision="bf16")``
  against ``jax.grad`` of the JAX ``make_train_step``'s bf16 loss, from
  seeded weights carried by the bridge:

  - each bf16-carry layer on the arguments and cotangents the port's step
    gave it, against ``jax.vjp`` of flax's cell on the same: within
    ``REL``, and the float32 recurrence misses it;
  - every parameter leaf of the model: the bf16 cells' leaves together
    (rel-L2 of their concatenation) within ``CELL_BOUND`` and every other
    leaf within ``REST_BOUND``, each 3× the readings (``PORT_VS_JAX``'s
    rule; ``CELL_BOUND`` no looser than before the Dense and norm repair).
    SkiM's bf16 ``proj`` and ``norm`` differentiate as ``jax.vjp`` does
    (``layers.dense_norm_bf16``, tests/test_torch_bf16_dense_norm_grad.py),
    the float32-carry LSTMs as ``jax.grad`` does
    (``ops.lstm_cell.f32_carry_lstm``, tests/test_torch_bf16_carry_grad.py),
    and causal SkiM's cLN rounds as the JAX cLN does
    (``layers.channel_norm_narrow``). What is left: causal SkiM, whose bf16
    forward is the JAX package's to 1.3e-7, equals ``jax.grad`` at every
    leaf but the encoder's kernel (1.1e-3, torch's bf16 convolution
    backward) and ``seg_lstm_0/proj/kernel`` (1.1e-5); ``hc``'s forward lies
    9.5e-6 and ``id``'s 2.9e-3 from JAX's at these widths, and their
    gradients carry that. The float32 recurrence's readings, also
    recorded, are held to be further than the kernel path's.

Widths: skim's tests' small model with 16 units; 0.25 s of audio (B=2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flax.linen as nn
import sonicsim_tpu.models as JM
from sonicsim_tpu.train import make_train_step as j_make_train_step
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch.models import zoo_layers
from sonicsim_tpu_torch.ops import lstm_cell
from sonicsim_tpu_torch.train import make_train_step

from test_torch_sep_train import _pit, _seeded
from test_torch_skim import SMALL
from test_torch_variants import _flax_leaves, _params
from torch_threads import one_intra_op_thread  # noqa: F401

K, D, H = 12, 16, 16
REL = 3.3e-3
# 3x the readings of (b): the worst other leaf 6.829e-3
# (seg_lstm_2/proj/bias), 3.145e-3 (seg_lstm_0/proj/bias), 1.076e-3
# (encoder/kernel), where torch's autograd of the Dense and norm read
# 2.589e-2, 2.030e-2 and 4.966e-2; the cells' leaves together 3.673e-3,
# 3.117e-3 and 2.714e-4 (before the Dense and norm repair 3.256e-3, 2.830e-3
# and 1.702e-3, whose bounds the first two keep); the float32 recurrence
# read 4.598e-3, 4.121e-3 and 7.284e-3 on the cells.
CELL_BOUND = {"id": 9.8e-3, "hc": 8.5e-3, "causal": 8.2e-4}
REST_BOUND = {"id": 2.05e-2, "hc": 9.5e-3, "causal": 3.3e-3}
T = 4000


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def f32(a) -> np.ndarray:
    return a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)


def jax_cell_vjp(x, w_ih, w_hh, bias, h0, c0, dy, dhn, dcn):
    """``jax.vjp`` of flax's bf16 ``nn.RNN(OptimizedLSTMCell)`` over D
    directions as the JAX SegLSTM runs them (direction 1 on ``x``
    reversed), the parameters float32 and cast to bfloat16 inside: the
    cotangents of ``x``, each direction's ``(W_ih, W_hh, bias)`` in torch's
    layout and of ``h0``, ``c0``, all float32 numpy. Arguments in the port's
    layout (``bf16_lstm``'s), as float32 numpy of bfloat16 values."""
    dirs, hidden = w_hh.shape[0], w_hh.shape[2]
    rnn = nn.RNN(nn.OptimizedLSTMCell(hidden))
    trees = [bridge._cell_to_flax({"l.weight_ih_l0": w_ih[d], "l.weight_hh_l0": w_hh[d],
                                   "l.bias_ih_l0": bias[d], "l.bias_hh_l0": 0 * bias[d]},
                                  "l", "l0") for d in range(dirs)]

    def run(ps, xx, h, c):
        outs, finals = [], []
        for d, p in enumerate(ps):
            p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
            xd = xx[:, ::-1] if d else xx
            (cn, hn), y = rnn.apply({"params": {"cell": p}}, xd, initial_carry=(c[d], h[d]),
                                    return_carry=True)
            outs.append(y[:, ::-1] if d else y)
            finals.append((hn, cn))
        return jnp.concatenate(outs, -1), jnp.stack([f[0] for f in finals]), jnp.stack(
            [f[1] for f in finals])

    as_bf16 = (lambda a: jnp.asarray(a, jnp.bfloat16))
    _, vjp = jax.vjp(run, [jax.tree.map(jnp.asarray, t) for t in trees], as_bf16(x),
                     as_bf16(h0), as_bf16(c0))
    gp, gx, gh, gc = jax.jit(vjp)((as_bf16(dy), as_bf16(dhn), as_bf16(dcn)))
    torch_layout = [bridge._cell_to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32), g),
                                          "l", "l0") for g in gp]
    weights = [np.stack([t[f"l.{n}_l0"] for t in torch_layout])
               for n in ("weight_ih", "weight_hh", "bias_ih")]
    return [np.asarray(a, np.float32) for a in (gx, *weights, gh, gc)]


def port_grads(args, cotangents, old=False):
    """The port's cotangents of ``bf16_lstm``'s arguments (x, W_ih, W_hh,
    bias, h0, c0), float32 numpy; with ``old``, through the float32
    recurrence of an ``LSTMLayer`` holding the same bf16 weights."""
    x, w_ih, w_hh, bias, h0, c0 = (bf16(a).requires_grad_() for a in args)
    dirs = w_hh.shape[0]
    reverse = [d == 1 for d in range(dirs)]
    if old:
        layer = zoo_layers.LSTMLayer(x.shape[-1], w_hh.shape[2], bidirectional=dirs == 2)
        weights = []
        for d in range(dirs):
            zero = torch.zeros_like(bias[d])
            weights += [w_ih[d], w_hh[d], bias[d], zero]
        y, (h, c) = zoo_layers._wide_recurrence(layer, torch._VF.lstm, 2, x, weights,
                                                (h0, c0), False)
    else:
        y, h, c = lstm_cell.bf16_lstm(x, w_ih, w_hh, bias, h0, c0, reverse)
    torch.autograd.backward((y, h, c), tuple(bf16(a) for a in cotangents))
    return [f32(t.grad) for t in (x, w_ih, w_hh, bias, h0, c0)]


def inputs(n, dirs, carry, seed):
    rng = np.random.default_rng(seed)

    def draw(shape, scale=1.0):
        return np.asarray(bf16(scale * rng.standard_normal(shape)).float())

    args = [draw((n, K, D)), draw((dirs, 4 * H, D), 0.3), draw((dirs, 4 * H, H), 0.3),
            draw((dirs, 4 * H), 0.3)]
    if carry == "zero":
        args += [np.zeros((dirs, n, H), np.float32)] * 2
    else:
        args += [np.tanh(draw((dirs, n, H))), draw((dirs, n, H))]
    cts = [draw((n, K, dirs * H)), draw((dirs, n, H)), draw((dirs, n, H))]
    return args, cts


NAMES = ("x", "W_ih", "W_hh", "bias", "h0", "c0")
CASES = [(n, dirs, carry) for n in (6, 70) for dirs in (1, 2) for carry in ("zero", "seeded")]


@pytest.mark.parametrize("n,dirs,carry", CASES,
                         ids=[f"{n}rows-{'bi' if d == 2 else 'uni'}-{c}" for n, d, c in CASES])
def test_cell_gradients_are_jax_vjp(n, dirs, carry):
    args, cts = inputs(n, dirs, carry, 11 * n + dirs + (carry == "seeded"))
    want = jax_cell_vjp(*args, *cts)
    got = port_grads(args, cts)
    dists = {k: rel_l2(g, w) for k, g, w in zip(NAMES, got, want)}
    print("rel-L2:", dists, "bit-equal:",
          {k: float((g == w).mean()) for k, g, w in zip(NAMES, got, want)})
    assert max(dists.values()) <= REL, dists
    old = {k: rel_l2(g, w) for k, g, w in zip(NAMES, port_grads(args, cts, old=True), want)}
    print("float32 recurrence rel-L2:", old)
    assert max(old.values()) > REL, old


def test_backward_entry_point_on_cpu_is_the_plain_version():
    args, cts = inputs(6, 2, "seeded", 0)
    xp = lstm_cell._projection(bf16(args[0]), bf16(args[1]))
    w_hh, bias, h0, c0 = (bf16(a) for a in args[2:])
    y, hn, cn, gates, c = lstm_cell.bf16_lstm_scan(xp, w_hh, bias, h0, c0, [False, True],
                                                   keep=True)
    assert all(torch.equal(a, b) for a, b in zip(
        (y, hn, cn), lstm_cell.bf16_lstm_scan(xp, w_hh, bias, h0, c0, [False, True])))
    dy, dhn, dcn = (bf16(a) for a in cts)
    got = lstm_cell.bf16_lstm_scan_backward(dy, dhn, dcn, gates, c, w_hh, c0, [False, True])
    ref = lstm_cell.bf16_lstm_scan_backward_ref(dy, dhn, dcn, gates, c, w_hh, c0,
                                                [False, True])
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    prods = lstm_cell.step_products(got[0], bf16(args[0]), y, h0, [False, True])
    assert all(torch.equal(a, b) for a, b in zip(
        lstm_cell.bf16_running_sum(prods, got[0], [False, True]),
        lstm_cell.bf16_running_sum_ref(prods, got[0], [False, True])))
    assert not any(lstm_cell.LAUNCHES.values())


def _grab():
    """An optax transformation whose state is the last gradient: the JAX
    step's own gradients, read from its returned state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _port_step(cfg, mix, tgt, loss, record=None):
    """The port's bf16 step with a zero learning rate: its gradients in the
    flax layout. ``record`` (a list) collects each bf16-carry layer's
    arguments and, after the step, the cotangents of its outputs."""
    model, _ = _seeded("SkiMNet", cfg)
    orig = zoo_layers.bf16_lstm

    def recording(*args):
        out = orig(*args)
        if record is not None:
            entry = {"args": [f32(a) for a in args[:6]], "cts": [np.zeros(t.shape, np.float32)
                                                                 for t in out]}
            record.append(entry)
            for i, t in enumerate(out):
                t.register_hook(functools.partial(_keep, entry["cts"], i))
        return out

    zoo_layers.bf16_lstm = recording
    try:
        step = make_train_step(model, loss, torch.optim.SGD(model.parameters(), lr=0.0),
                               precision="bf16", clip_norm=None)
        step(torch.from_numpy(mix), torch.from_numpy(tgt))
    finally:
        zoo_layers.bf16_lstm = orig
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return [np.asarray(a) for a in _flax_leaves("SkiMNet", model, grads)]


def _keep(cts: list, i: int, grad) -> None:
    if grad is not None:  # an output the loss does not read keeps its zeros
        cts[i] = f32(grad)


def _old_path(rnn, x, weights, states):
    return zoo_layers._wide_recurrence(rnn, torch._VF.lstm, 2, x, weights, states, False)


SKIM_CASES = {"id": dict(causal=False, seg_overlap=True, mem_type="id"),
              "hc": dict(causal=False, seg_overlap=True, mem_type="hc"),
              "causal": dict(causal=True, seg_overlap=False, mem_type="hc")}


@pytest.mark.parametrize("case", list(SKIM_CASES))
def test_skim_bf16_step_gradients_are_jax(case, monkeypatch):
    cfg = dict(SMALL, unit=H, **SKIM_CASES[case])
    mem_type = cfg["mem_type"]
    rng = np.random.default_rng(0)
    mix = (0.3 * rng.standard_normal((2, T))).astype(np.float32)
    tgt = (0.03 * rng.standard_normal((2, 2, T))).astype(np.float32)
    loss, j_loss = _pit()
    _, params = _seeded("SkiMNet", cfg)
    step = jax.jit(j_make_train_step(JM.get("SkiMNet")(**cfg), j_loss, _grab(),
                                     precision="bf16"))
    _, j_grads, _ = step(params, _grab().init(params), jnp.asarray(mix), jnp.asarray(tgt))
    want = [np.asarray(a, np.float32) for a in _params(j_grads)]
    names = ["/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(params["params"])[0]]
    cell = [i for i, nm in enumerate(names) if nm.startswith("seg_lstm")
            and "OptimizedLSTMCell" in nm and (mem_type == "id" or nm.startswith("seg_lstm_0"))]
    record = []
    got = _port_step(cfg, mix, tgt, loss, record)
    assert len(record) == (cfg["layer"] if mem_type == "id" else 1)
    # Each bf16-carry layer on what the step gave it, against flax's cell.
    for entry in record:
        want_layer = jax_cell_vjp(*entry["args"], *entry["cts"])
        layer = {k: rel_l2(g, w) for k, g, w in zip(NAMES, port_grads(entry["args"],
                                                                      entry["cts"]), want_layer)}
        print("layer rel-L2:", layer)
        assert max(layer.values()) <= REL, layer
        old = [rel_l2(g, w) for g, w in zip(port_grads(entry["args"], entry["cts"], old=True),
                                            want_layer)]
        assert max(old) > REL, old
    # The model's leaves.
    monkeypatch.setattr(zoo_layers, "_bf16_cell", _old_path)
    before = _port_step(cfg, mix, tgt, loss)
    monkeypatch.undo()

    def cat(g):
        return np.concatenate([np.ravel(g[i]) for i in cell])

    cells = rel_l2(cat(got), cat(want)), rel_l2(cat(before), cat(want))
    rest, worst = max((rel_l2(got[i], want[i]), names[i]) for i in range(len(want))
                      if i not in cell)
    print(f"bf16 cells' leaves rel-L2: kernels {cells[0]:.3e}, float32 recurrence "
          f"{cells[1]:.3e}; worst other leaf {rest:.3e} ({worst})")
    assert cells[0] <= CELL_BOUND[case] and rest <= REST_BOUND[case], (cells, rest)
    assert cells[0] < cells[1]
