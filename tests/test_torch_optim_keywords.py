"""optax's keywords beyond the defaults, in the port against optax, on the CPU.

The cases set, between them, every keyword the port once took at its
default only: Adam's ``eps_root``, ``mu_dtype`` and ``nesterov``, adamw's
``mask``, SGD's ``accumulator_dtype``, adadelta's, lars's and adafactor's
``weight_decay_mask``, lars's ``trust_ratio_mask``, lion's ``mu_dtype`` and
``mask``, lamb's ``mask`` and adafactor's ``dtype_momentum``. A mask is a
tree of booleans over the flax tree, a prefix of one, or a callable on the
tree; a dtype is a name, as the JAX factory passes it to optax.

Rule and model: tests/test_torch_optim.py's (three seeded gradient trees on
DPTNet through the bridge, the clip firing on one step, the learning rate
changed after the first; every parameter within 2e-5·max|Δp| plus two
float32 spacings of optax's). The reference is the JAX factory
(``sonicsim_tpu.train.trainer.make_optimizer``) with every mask given as
the tree it selects: optax calls a callable mask on the parameters' tree,
but the factory's ``inject_hyperparams`` would take a callable for a
schedule (ROADMAP C22). A case that gives the port the callable and one
that gives it the tree share that reference, computed once.
"""

import jax
import numpy as np
import optax
import pytest

from sonicsim_tpu.train import trainer as JT
from sonicsim_tpu_torch.models import base as TB
from sonicsim_tpu_torch.train import make_optimizer
from sonicsim_tpu_torch.train import optim

from test_torch_optim import LR, REL, ULPS, port_model, port_steps, setup
from torch_threads import one_intra_op_thread  # noqa: F401


def kernels_only(tree):
    """A mask function: the leaves of two or more axes (kernels, not
    biases or norm scales)."""
    return jax.tree.map(lambda x: np.ndim(x) > 1, tree)


def alternate_prefix(params):
    """A prefix mask: every other top-level module of the flax tree."""
    return {"params": {k: i % 2 == 0 for i, k in enumerate(params["params"])}}


# id: (optimizer, weight decay, keywords, whether the port takes a mask
# function itself; else the tree it returns for the seeded flax params)
CASES = {
    "adam-mu_dtype": ("adam", 0.0, dict(mu_dtype="bfloat16"), False),
    "adamw-mask-tree": ("adamw", 0.1, dict(mask=kernels_only), False),
    "adamw-mask-callable": ("adamw", 0.1, dict(mask=kernels_only), True),
    "adamw-everything": ("adamw", 0.1, dict(eps_root=1e-4, mu_dtype="bfloat16", nesterov=True,
                                            mask=alternate_prefix), False),
    "sgd-accumulator_dtype-nesterov": ("sgd", 0.0, dict(momentum=0.9, nesterov=True,
                                                        accumulator_dtype="bfloat16"), False),
    "adadelta-weight_decay_mask": ("adadelta", 0.1, dict(weight_decay_mask=alternate_prefix),
                                   False),
    "lion-mu_dtype-mask": ("lion", 0.1, dict(mu_dtype="bfloat16", mask=kernels_only), False),
    "lamb-mask-callable": ("lamb", 0.1, dict(mask=kernels_only), True),
    "lars-masks": ("lars", 0.1, dict(weight_decay_mask=kernels_only,
                                     trust_ratio_mask=kernels_only), True),
    "adafactor-dtype_momentum-weight_decay_mask": ("adafactor", 0.0, dict(
        momentum=0.9, dtype_momentum="bfloat16", weight_decay_rate=0.1,
        weight_decay_mask=kernels_only), False),
}


def resolve(kwargs: dict, params) -> dict:
    """Each mask function replaced by the tree it returns for ``params``."""
    return {k: v(params) if callable(v) else v for k, v in kwargs.items()}


def run_jax(opt, params, grads, jit=True):
    from test_torch_optim import LR2

    state = opt.init(params)
    p = jax.tree.map(np.asarray, params)
    # adafactor's injected integer hyperparameters do not trace.
    update = opt.update if jit is False else jax.jit(opt.update)
    for k, g in enumerate(grads):
        updates, state = update(g, state, p)
        p = optax.apply_updates(p, updates)
        if k == 0:
            state = JT.set_learning_rate(state, LR2)
    return jax.tree.map(np.asarray, p)


_WANT = {}


def optax_params(name, wd, kwargs):
    """The JAX factory's parameters after the three steps, the masks as
    trees; one run per optimizer and keywords."""
    key = (name, wd, tuple((k, getattr(v, "__name__", v)) for k, v in kwargs.items()))
    if key not in _WANT:
        _, _, params, grads, clip = setup("dptnet")
        opt = JT.make_optimizer(LR, wd, clip, name=name, **resolve(kwargs, params))
        _WANT[key] = run_jax(opt, params, grads, jit=name != "adafactor")
    return _WANT[key]


@pytest.mark.parametrize("case", list(CASES))
def test_keyword_matches_optax(case):
    name, wd, kwargs, callable_mask = CASES[case]
    mname, _, params, grads, clip = setup("dptnet")
    want = optax_params(name, wd, kwargs)
    model = port_model("dptnet")
    opt = make_optimizer(model, LR, wd, name,
                         **(kwargs if callable_mask else resolve(kwargs, params)))
    assert isinstance(opt, optim.OptaxOptimizer)
    port_steps(model, name, grads, clip, wd, opt=opt)
    got = TB.to_flax(mname, model.state_dict(), model.model_args())
    flat_w, flat_g, flat_0 = (dict(jax.tree_util.tree_flatten_with_path(t)[0])
                              for t in (want, got, params))
    moved = max(float(np.abs(flat_w[k] - flat_0[k]).max()) for k in flat_w)
    assert moved > 0
    for k, w in flat_w.items():
        err = np.abs(np.asarray(flat_g[k]) - w)
        assert (err <= REL * moved + ULPS * np.spacing(np.abs(w))).all(), (
            jax.tree_util.keystr(k), float(err.max()), moved)


def test_masks_and_dtypes_take_effect():
    """Each keyword changes the step (the cases above are not the defaults
    in disguise), and a rounded moment is stored rounded."""
    _, _, params, grads, clip = setup("dptnet")
    ref = port_model("dptnet")
    port_steps(ref, "adamw", grads, clip, 0.1)
    masked = port_model("dptnet")
    port_steps(masked, "adamw", grads, clip, 0.1,
               opt=make_optimizer(masked, LR, 0.1, "adamw", mask=kernels_only))
    moved = [not np.array_equal(a.detach().numpy(), b.detach().numpy())
             for a, b in zip(ref.parameters(), masked.parameters())]
    assert any(moved) and not all(moved)  # the biases and norms stay as adamw's
    model = port_model("dptnet")
    opt = port_steps(model, "adam", grads, clip, 0.0,
                     opt=make_optimizer(model, LR, 0.0, "adam", mu_dtype="bfloat16"))
    mus = [opt.state[p]["mu"] for p in opt.param_groups[0]["params"]]
    assert all(str(m.dtype) == "torch.bfloat16" for m in mus)


def test_the_selection_follows_the_flax_leaves():
    """A prefix mask and a callable reach the flax leaves the JAX tree
    names: an LSTM's input and hidden kernels are leaves of their own, and
    its flax bias (``bias_ih`` + ``bias_hh`` in the port) one leaf."""
    model = port_model("dptnet")
    lm = optim.flax_leaf_map(model)
    sel = optim.leaf_selection(lm, kernels_only)
    names = [n for n, _, _ in lm.leaves]
    assert all(on == (len(s) > 1) for on, (_, s, _) in zip(sel, lm.leaves))
    assert any(n.endswith("ii/kernel") for n, on in zip(names, sel) if on)
    assert not any(n.endswith("hi/bias") for n, on in zip(names, sel) if on)
    assert optim.leaf_selection(lm, None) is None and optim.leaf_selection(lm, True) is None
    assert not any(optim.leaf_selection(lm, False))
    tree = optim.param_tree(lm)
    assert set(tree) == {"params"}


def test_the_jax_factory_takes_a_callable_mask_for_a_schedule():
    """ROADMAP C22: through the JAX factory a callable mask is called with
    the step count (``inject_hyperparams``'s schedules), which selects no
    leaf, so adamw decays nothing: its step is the all-False mask's. The
    port computes optax's function of the mask instead (the cases above)."""
    _, _, params, grads, clip = setup("dptnet")
    factory = run_jax(JT.make_optimizer(LR, 0.1, clip, name="adamw", mask=kernels_only),
                      params, grads, jit=False)
    none = run_jax(JT.make_optimizer(LR, 0.1, clip, name="adamw",
                                     mask=jax.tree.map(lambda x: False, params)),
                   params, grads, jit=False)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(factory),
                                                    jax.tree.leaves(none)))
