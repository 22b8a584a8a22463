"""The optimizer zoo in the port against the JAX factory
(``sonicsim_tpu.train.trainer.make_optimizer``, optax), all fourteen names.

The same three seeded gradient trees go to optax on the flax tree and to
the port's optimizer through the bridge, with the factory's clip set so it
fires on one step, the learning rate changed after the first step
(``set_learning_rate``, optax's injected hyperparameter) and the weight
decay 0 and above 0. The elementwise ten run on DPTNet (convolutions,
LSTMs with a frozen ``bias_hh``, MHA split into query, key and value
leaves); the layerwise four (lamb, lars, novograd, adafactor) also on the
GRU FullSubNet (the GRU ``bias_hh``'s r and z thirds no flax leaf holds)
and G2Net (one flax conv held by two port convs), where their per-leaf
statistics must run over flax's leaves, and on a bare tensor list with a
leaf adafactor factors.

Tolerance: after three steps, every parameter within 2e-5 · max|Δp| of
optax's, plus two float32 spacings of the parameter (each side rounds its
sum p + u; adadelta moves a parameter by as little as an ulp): float32 on
both sides, the hyperparameters float32 arrays in optax and Python floats
here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from sonicsim_tpu.train import trainer as JT
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.models import base as TB
from sonicsim_tpu_torch.train import make_optimizer, set_learning_rate
from sonicsim_tpu_torch.train import optim
from sonicsim_tpu_torch.train.trainer import clip_by_global_norm

from test_torch_enh_models import SMALL as ENH_SMALL
from test_torch_gagnet import SMALL as GAG_SMALL
from test_torch_zoo_models import SMALL as ZOO_SMALL
from torch_threads import one_intra_op_thread  # noqa: F401

NAMES = ["adam", "adamw", "sgd", "rmsprop", "adagrad", "adadelta", "lamb", "lars", "radam",
         "adafactor", "novograd", "yogi", "adabelief", "lion"]
MODELS = {
    "dptnet": ("DPTNetModel", ZOO_SMALL["DPTNetModel"]),
    "fullsubnet-gru": ("FullSubnet", dict(ENH_SMALL["FullSubnet"], sequence_model="GRU")),
    "g2net": ("G2Net", dict(GAG_SMALL["G2Net"], stage_num=1, dilas=(1,))),
}
LR, LR2, REL, ULPS = 1e-2, 4e-3, 2e-5, 2
CASES = ([(n, "dptnet", wd) for n in NAMES for wd in (0.0, 0.1)]
         + [(n, m, 0.1) for n in optim.LAYERWISE for m in ("fullsubnet-gru", "g2net")])


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(k, v) for k, v in tree.items()}


def _grads(tree, seed):
    """Three gradient trees of ``tree``'s shapes, the second ten times the
    others' scale."""
    rng = np.random.default_rng(seed)
    return [_tree_map(lambda k, v: (s * rng.standard_normal(np.shape(v))).astype(np.float32),
                      tree) for s in (1.0, 10.0, 1.0)]


def _norm(tree) -> float:
    return float(np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64)))
                             for v in jax.tree.leaves(tree))))


_SETUP = {}


def setup(model_key):
    if model_key not in _SETUP:
        name, cfg = MODELS[model_key]
        model = TM.get(name)(**cfg, device="cpu")
        args = model.model_args()
        params = chip_smoke.seeded_flax(TB.to_flax(name, model.state_dict(), args), 0)
        grads = _grads(params, 1)
        norms = sorted(_norm(g) for g in grads)
        _SETUP[model_key] = (name, cfg, params, grads, float(np.sqrt(norms[1] * norms[2])))
    return _SETUP[model_key]


def run_jax(name, params, grads, clip, wd):
    opt = JT.make_optimizer(LR, wd, clip, name=name)
    state = opt.init(params)
    p = jax.tree.map(jnp.asarray, params)
    # One compile for the layerwise updates, whose eager form dispatches
    # dozens of small ops per leaf; adafactor's injected integer
    # hyperparameters do not trace.
    update = jax.jit(opt.update) if name in ("novograd", "lamb", "lars") else opt.update
    for k, g in enumerate(grads):
        updates, state = update(jax.tree.map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, updates)
        if k == 0:
            state = JT.set_learning_rate(state, LR2)
    return jax.tree.map(np.asarray, p)


def port_model(model_key):
    name, cfg, params, _, _ = setup(model_key)
    model = TM.get(name)(**cfg, device="cpu")
    model.load_state_dict(TB.to_state_dict(name, params, model.model_args()))
    return model


def port_steps(model, name, grads, clip, wd, opt=None, steps=range(3)):
    args = model.model_args()
    opt = opt or make_optimizer(model, LR, wd, name)
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    for k in steps:
        g = TB.to_state_dict(type(model).__name__, grads[k], args)
        for n, p in trainable.items():
            p.grad = g[n].clone()
        clip_by_global_norm([p.grad for p in trainable.values()], clip)
        opt.step()
        if k == 0:
            set_learning_rate(opt, LR2)
    return opt


@pytest.mark.parametrize("name,model_key,wd", CASES,
                         ids=[f"{n}-{m}-wd{w:g}" for n, m, w in CASES])
def test_three_steps_match_optax(name, model_key, wd):
    mname, _, params, grads, clip = setup(model_key)
    assert sum(_norm(g) > clip for g in grads) == 1  # the clip fires on one step
    want = run_jax(name, params, grads, clip, wd)
    model = port_model(model_key)
    port_steps(model, name, grads, clip, wd)
    got = TB.to_flax(mname, model.state_dict(), model.model_args())
    flat_w, flat_g, flat_0 = (dict(jax.tree_util.tree_flatten_with_path(t)[0])
                              for t in (want, got, {"params": params["params"]}
                                        if "params" in params else params))
    moved = max(float(np.abs(flat_w[k] - flat_0[k]).max()) for k in flat_w)
    assert moved > 0
    for k, w in flat_w.items():
        err = np.abs(np.asarray(flat_g[k]) - w)
        assert (err <= REL * moved + ULPS * np.spacing(np.abs(w))).all(), (
            jax.tree_util.keystr(k), float(err.max()), moved)


@pytest.mark.parametrize("name", ["adafactor", "lamb", "novograd"])
def test_bare_tensors_and_a_factored_leaf(name):
    """A bare parameter list, each tensor one leaf: a (130, 140) leaf, which
    adafactor factors, a vector and a 3-D leaf."""
    rng = np.random.default_rng(7)
    shapes = {"a": (130, 140), "b": (5,), "c": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    want = run_jax(name, params, grads, 1e9, 0.0)
    ts = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in shapes]
    opt = make_optimizer(ts, LR, 0.0, name)
    for k, g in enumerate(grads):
        for t, key in zip(ts, shapes):
            t.grad = torch.from_numpy(g[key])
        opt.step()
        if k == 0:
            set_learning_rate(opt, LR2)
    moved = max(float(np.abs(want[k] - params[k]).max()) for k in shapes)
    for t, key in zip(ts, shapes):
        err = np.abs(t.detach().numpy() - want[key])
        assert (err <= REL * moved + ULPS * np.spacing(np.abs(want[key]))).all(), key
    if name == "adafactor":
        assert {k for k in opt.state if isinstance(k, str)} >= {"leaf0", "count"}
        assert set(opt.state["leaf0"]) == {"v_row", "v_col"}


@pytest.mark.parametrize("name", ["lamb", "adafactor", "novograd", "yogi", "lion"])
def test_resume_from_state_dict(name):
    """One step, the optimizer's ``state_dict`` into a new optimizer, two more:
    the same parameters as three steps without the break."""
    _, _, _, grads, clip = setup("dptnet")
    whole = port_model("dptnet")
    port_steps(whole, name, grads, clip, 0.1)
    model = port_model("dptnet")
    first = port_steps(model, name, grads, clip, 0.1, steps=[0])
    opt = make_optimizer(model, LR, 0.1, name)
    opt.load_state_dict(first.state_dict())
    assert opt.param_groups[0]["lr"] == LR2
    port_steps(model, name, grads, clip, 0.1, opt=opt, steps=[1, 2])
    for (n, a), b in zip(whole.named_parameters(), model.parameters()):
        assert torch.equal(a, b), n


def test_factory_rules():
    model = port_model("dptnet")
    with pytest.raises(TypeError, match="momentum_x"):
        make_optimizer(model, name="sgd", momentum_x=0.9)
    with pytest.raises(TypeError):
        JT.make_optimizer(name="sgd", momentum_x=0.9).init({"w": jnp.zeros(2)})
    assert make_optimizer(model, name="lion").defaults["weight_decay"] == 1e-3  # optax's
    assert make_optimizer(model, name="lion", weight_decay=0.2).defaults["weight_decay"] == 0.2
    assert make_optimizer(model, name="adadelta").defaults["weight_decay"] == 0.0
    assert make_optimizer(model, name="sgd", momentum=0.5).defaults["momentum"] == 0.5
    assert make_optimizer(model, name="rmsprop").defaults["eps_in_sqrt"] is True
    assert type(make_optimizer(model, name="adam", weight_decay=0.1)) is torch.optim.AdamW
    with pytest.raises(KeyError):
        make_optimizer(model, name="nope")


def test_leaves_are_flax_leaves():
    """DPTNet's MHA ``in_proj_weight`` holds three flax leaves, an LSTM's
    ``weight_ih`` four, and its frozen ``bias_hh`` reaches no optimizer; the
    GRU's ``bias_hh`` r and z thirds are masked out."""
    model = port_model("dptnet")
    lm = optim.flax_leaf_map(model)
    names = [p for p, _, _ in lm.leaves]
    assert any(p.endswith("query/kernel") for p in names)
    assert any(p.endswith("hi/kernel") for p in names) and any(p.endswith("ii/kernel")
                                                                for p in names)
    assert not any(p is q for p in lm.params for n, q in model.named_parameters()
                   if "bias_hh" in n)
    total = sum(p.numel() for p in lm.params)
    held = torch.cat([i for _, _, i in lm.leaves])
    assert held.numel() == total and torch.equal(held.sort().values, torch.arange(total))
    gru = optim.flax_leaf_map(port_model("fullsubnet-gru"))
    assert gru.masks and all(int((~m).sum()) == 2 * m.shape[0] // 3 for m in gru.masks.values())
