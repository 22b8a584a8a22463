"""optax's optimizers as ``torch.optim.Optimizer`` subclasses.

Port of the optimizer zoo behind ``sonicsim_tpu.train.trainer
.make_optimizer`` (the reference's look2hear/system/optimizers.py:8-113 on
optax): sgd, rmsprop, adagrad, adadelta, lamb, lars, radam, adafactor,
novograd, yogi, adabelief and lion, and adam and adamw with the keywords
``torch.optim.Adam`` has no counterpart for. Each computes optax 0.2.6's
arithmetic term by term, not PyTorch's nearest optimizer
(``torch.optim.RMSprop`` takes g/(√ν + ε), optax's ``rmsprop`` g/√(ν + ε);
``Adagrad`` starts its sum at 0, optax's at 0.1; …). Each takes the optax
function's keywords and raises ``TypeError`` on any other, as the optax
function does. ``lr`` in ``param_groups`` is optax's injected
``learning_rate`` (``trainer.set_learning_rate``); the other numbers are
injected too, as float32 scalars, so a moment stored in a narrower dtype
(``mu_dtype``, ``accumulator_dtype``, ``dtype_momentum``) enters the
arithmetic widened, the step takes the moment as computed, and the state
keeps it rounded (``optax.tree.cast``).

**Masks** (``mask``, ``weight_decay_mask``, ``trust_ratio_mask``) are
optax's: a tree of booleans, a prefix of it, or a callable that returns one
from the parameters' tree. That tree is the JAX package's flax tree of the
model (:func:`param_tree`: the flax leaves' shapes and the parameters'
values; a bare parameter list is a dict of its positions), so one mask
gives the same step in both packages. The mask is evaluated once, on the
parameters the optimizer is made with (optax evaluates it on each step's
updates, which have their shapes).

**Leaves.** lamb and lars take a trust ratio per leaf, novograd keeps one
second moment per leaf, adafactor factors each leaf and scales it by the
leaf's RMS. Their leaf is a leaf of the JAX package's flax tree, and one
port tensor may hold several (an LSTM's four gates, MHA's query, key and
value, DCCRN's two BatchNorm halves) or share one with another (flax's
LSTM bias is ``bias_ih + bias_hh``). :func:`flax_leaf_map` finds each flax
leaf's elements once, by putting index tensors through the bridge
(``models.base.to_flax``); the statistics are then taken over the flax
leaf in its flax shape. Elements that no flax leaf holds (a GRU's
``bias_hh`` r and z thirds, TDANet's unused query and key rows) take no
update in any of the twelve; frozen tensors (an LSTM's ``bias_hh``) are not
handed to the optimizer at all. A bare parameter list
(:func:`tensor_leaf_map`) takes each tensor as one leaf.

Elementwise updates run as ``torch._foreach_*`` passes over the tensors;
the per-leaf statistics as a loop over the leaves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn as nn


@dataclass
class LeafMap:
    """The tensors an optimizer updates and the leaves its statistics run
    over: ``leaves`` = [(name, flax shape, flat index into the tensors
    joined in order)], ``masks`` = {tensor position: the boolean mask of
    its elements some leaf holds}, where that is not every element;
    ``shapes`` = the whole flax tree with each leaf's shape (the optimizer's
    leaves, found under ``prefix``, and frozen statistics alike)."""

    params: list
    leaves: list
    masks: dict = field(default_factory=dict)
    shapes: dict = field(default_factory=dict)
    prefix: str = ""


def tensor_leaf_map(params) -> LeafMap:
    """Each tensor of ``params`` its own leaf."""
    params = [p for p in params if p.requires_grad]
    leaves, start = [], 0
    for i, p in enumerate(params):
        leaves.append((str(i), tuple(p.shape), torch.arange(start, start + p.numel())))
        start += p.numel()
    return LeafMap(params, leaves, shapes={n: s for n, s, _ in leaves})


def _flat_tree(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_tree(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def flax_leaf_map(model: nn.Module) -> LeafMap:
    """``model``'s trainable tensors and the leaves of its flax tree: each
    trainable element is marked with its flat index + 1 (float64, exact),
    every other entry of the state dict and every element no flax
    parameter holds (``frozen_elements``) with 0, and the marks are put
    through ``models.base.to_flax``."""
    from ..models.base import to_flax

    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    marks = {k: np.zeros(tuple(v.shape)) for k, v in model.state_dict().items()}
    frozen = {}
    for prefix, module in model.named_modules():
        if hasattr(module, "frozen_elements"):
            frozen.update({f"{prefix}.{k}" if prefix else k: m
                           for k, m in module.frozen_elements().items()})
    start = 0
    for n, p in named:
        mark = np.arange(start + 1, start + p.numel() + 1, dtype=np.float64).reshape(p.shape)
        if n in frozen:
            mark[frozen[n].numpy()] = 0
        marks[n] = mark
        start += p.numel()
    tree = to_flax(type(model).__name__, marks, model.model_args())
    leaves, held = [], np.zeros(start, dtype=bool)
    prefix = "params/" if "params" in tree else ""
    for path, leaf in _flat_tree(tree.get("params", tree)):
        leaf = np.asarray(leaf, np.float64)
        if not leaf.any():
            continue  # frozen statistics: no parameter of the JAX tree's optimizer
        ids = np.rint(leaf).astype(np.int64) - 1
        if (ids < 0).any() or not np.array_equal(ids + 1, leaf) or held[ids].any():
            raise ValueError(f"flax leaf {path} does not map onto distinct trainable elements")
        held[ids.reshape(-1)] = True
        leaves.append((path, tuple(leaf.shape), torch.from_numpy(ids.reshape(-1))))
    masks, start = {}, 0
    for i, (_, p) in enumerate(named):
        part = held[start:start + p.numel()]
        if not part.all():
            masks[i] = torch.from_numpy(part.reshape(tuple(p.shape)).copy())
        start += p.numel()
    return LeafMap([p for _, p in named], leaves, masks, _shapes(tree), prefix)


def _shapes(tree: dict) -> dict:
    return {k: _shapes(v) if isinstance(v, dict) else tuple(np.shape(v)) for k, v in tree.items()}


def param_tree(leaf_map: LeafMap) -> dict:
    """The flax tree a mask is evaluated on: each optimizer leaf holds its
    parameters' values (numpy, in the flax shape), every other leaf (frozen
    statistics) zeros of its shape."""
    flat = _join([p.detach() for p in leaf_map.params]).cpu()
    values = {leaf_map.prefix + n: flat[i].reshape(s).numpy() for n, s, i in leaf_map.leaves}

    def fill(node: dict, path: str) -> dict:
        return {k: fill(v, f"{path}{k}/") if isinstance(v, dict)
                else values.get(path + k, np.zeros(v, np.float32)) for k, v in node.items()}

    return fill(leaf_map.shapes, "")


def leaf_selection(leaf_map: LeafMap, mask) -> list | None:
    """optax's ``mask`` over ``leaf_map``'s leaves: one bool per leaf, or None
    where it selects every leaf (``None`` or ``True``). ``mask`` is a tree
    of booleans or a prefix of one (a boolean covers the subtree under
    it), or a callable returning one from :func:`param_tree`; a list or
    tuple stands for the dict of its positions."""
    if mask is None or mask is True:
        return None
    if callable(mask):
        mask = mask(param_tree(leaf_map))
    out = []
    for name, _, _ in leaf_map.leaves:
        node = mask
        for key in (leaf_map.prefix + name).split("/"):
            if isinstance(node, (list, tuple)):
                node = node[int(key)]
            elif isinstance(node, dict):
                node = node[key]
            else:
                break
        out.append(bool(node))
    return out


def moment_dtype(dtype) -> torch.dtype | None:
    """optax's moment dtype keyword (None, a name such as ``"bfloat16"``,
    a numpy dtype or a ``torch.dtype``) as a ``torch.dtype``, or None: the
    gradients' own."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return out


def _join(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


class OptaxOptimizer(torch.optim.Optimizer):
    """One optax optimizer over a :class:`LeafMap`'s tensors. A subclass
    names its optax keywords and their defaults: the numbers and flags
    (``KEYWORDS``, kept in ``param_groups``), the masks (``MASKS``, kept as
    :func:`leaf_selection`'s booleans in ``self.masks``) and the moment
    dtypes (``DTYPES``, kept as :func:`moment_dtype`'s in ``self.dtypes``),
    and computes :meth:`updates`: the update each tensor's elements are
    moved by (optax's ``updates``, added to the parameters)."""

    KEYWORDS: dict = {}
    MASKS: dict = {}
    DTYPES: dict = {}

    def __init__(self, leaf_map: LeafMap, lr: float, **kwargs):
        name = type(self).__name__.lower()
        for k in kwargs:
            if k not in self.KEYWORDS and k not in self.MASKS and k not in self.DTYPES:
                raise TypeError(f"{name}() got an unexpected keyword argument {k!r}")
        defaults = dict(self.KEYWORDS, **{k: v for k, v in kwargs.items() if k in self.KEYWORDS})
        super().__init__(leaf_map.params, dict(lr=lr, **defaults))
        self.leaf_map = leaf_map
        self.masks = {k: leaf_selection(leaf_map, kwargs.get(k, d)) for k, d in self.MASKS.items()}
        self.dtypes = {k: moment_dtype(kwargs.get(k, d)) for k, d in self.DTYPES.items()}
        self._index: dict = {}
        self._selected: dict = {}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        ps = group["params"]
        gs = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
        states = [self.state[p] for p in ps]
        count = self.state.setdefault("count", 0) + 1  # optax's safe_increment of its count
        self.state["count"] = count
        us = list(self.updates(group, ps, gs, states, count))
        for i, mask in self.leaf_map.masks.items():
            us[i] = torch.where(mask.to(us[i].device), us[i], 0)
        torch._foreach_add_(ps, us)
        return loss

    def updates(self, group, ps, gs, states, count) -> list:
        raise NotImplementedError

    # --- per-leaf helpers ---------------------------------------------------------

    def leaves(self, device):
        """(name, flax shape, flat index on ``device``) of each leaf."""
        if device not in self._index:
            self._index[device] = [(n, s, i.to(device)) for n, s, i in self.leaf_map.leaves]
        return self._index[device]

    @staticmethod
    def split(flat: torch.Tensor, like: list) -> list:
        out, start = [], 0
        for p in like:
            out.append(flat[start:start + p.numel()].view_as(p))
            start += p.numel()
        return out

    def selected(self, key: str, ps: list) -> list | None:
        """Mask ``key``'s elements of each tensor of ``ps`` (bool tensors on
        their device), or None where it selects every leaf."""
        leaves = self.masks[key]
        if leaves is None:
            return None
        device = ps[0].device
        if (key, device) not in self._selected:
            flat = torch.zeros(sum(p.numel() for p in ps), dtype=torch.bool)
            for on, (_, _, idx) in zip(leaves, self.leaf_map.leaves):
                flat[idx] = on
            self._selected[key, device] = [m.to(device) for m in self.split(flat, ps)]
        return self._selected[key, device]

    def decayed(self, key: str, us: list, ps: list, weight_decay: float) -> list:
        """optax's ``add_decayed_weights(weight_decay, mask)``: u + wd·p on
        the elements mask ``key`` selects, u elsewhere (a new list)."""
        sel = self.selected(key, ps)
        if sel is None:
            return torch._foreach_add(us, ps, alpha=weight_decay)
        return [torch.where(m, u + weight_decay * p, u) for u, p, m in zip(us, ps, sel)]


def _moment(ms, gs, decay: float, order: int = 1):
    """optax's ``update_moment``: m ← (1 − decay)·gᵒʳᵈᵉʳ + decay·m, in place."""
    torch._foreach_mul_(ms, decay)
    if order == 1:
        torch._foreach_add_(ms, gs, alpha=1 - decay)
    else:
        torch._foreach_addcmul_(ms, gs, gs, value=1 - decay)


def _state(states, ps, key: str, fill: float = 0.0, dtype: torch.dtype | None = None) -> list:
    for s, p in zip(states, ps):
        if key not in s:
            s[key] = torch.full_like(p, fill, dtype=dtype, memory_format=torch.preserve_format)
    return [s[key] for s in states]


def _stored_moment(states, ps, gs, key: str, decay: float, dtype: torch.dtype | None) -> list:
    """optax's first-moment ``update_moment`` on a moment stored in
    ``dtype`` (None: the gradients'): (1 − decay)·g + decay·m on m widened
    to the gradients' dtype; returns the moment as computed and stores it
    cast to ``dtype`` (``optax.tree.cast``). Where the moment is rounded,
    1 − decay is optax's float32 one and each product is rounded apart, so
    the rounding sees optax's values."""
    ms = _state(states, ps, key, dtype=dtype)
    if dtype is None:
        _moment(ms, gs, decay, 1)
        return ms
    new = torch._foreach_add(_scaled(gs, _complement(decay)),
                             _scaled([m.to(g.dtype) for m, g in zip(ms, gs)], decay))
    for s, m in zip(states, new):
        s[key] = m.to(dtype)
    return new


def _complement(decay: float) -> float:
    """1 − decay as optax computes it on its injected float32 hyperparameter."""
    return float(np.float32(1) - np.float32(decay))


def _mu_hat(mus, gs, b1: float, count: int, nesterov: bool) -> list:
    """optax's bias-corrected first moment, with Nesterov's look-ahead
    b1·m/(1 − b1^(t+1)) + (1 − b1)·g/(1 − b1^t)."""
    if nesterov:
        return torch._foreach_add(_scaled(mus, b1 / (1 - b1**(count + 1))),
                                  _scaled(gs, (1 - b1) / (1 - b1**count)))
    return _scaled(mus, 1 / (1 - b1**count))


def _scaled(ts, s: float) -> list:
    return torch._foreach_mul(ts, s)


def _trace(states, ps, us, decay: float, nesterov: bool, dtype: torch.dtype | None = None
           ) -> list:
    """optax's ``trace``: t ← u + decay·t; the update t, or u + decay·t with
    Nesterov; t stored in ``dtype`` (None: the updates')."""
    ts = _state(states, ps, "trace", dtype=dtype)
    if dtype is None:
        torch._foreach_mul_(ts, decay)
        torch._foreach_add_(ts, us)
    else:
        ts = torch._foreach_add(us, _scaled([t.to(u.dtype) for t, u in zip(ts, us)], decay))
        for s, t in zip(states, ts):
            s["trace"] = t.to(dtype)
    return torch._foreach_add(us, _scaled(ts, decay)) if nesterov else [t.clone() for t in ts]


class SGD(OptaxOptimizer):
    KEYWORDS = dict(momentum=None, nesterov=False)
    DTYPES = dict(accumulator_dtype=None)

    def updates(self, group, ps, gs, states, count):
        us = list(gs)
        if group["momentum"] is not None:
            us = _trace(states, ps, us, group["momentum"], group["nesterov"],
                        self.dtypes["accumulator_dtype"])
        return _scaled(us, -group["lr"])


class RMSProp(OptaxOptimizer):
    KEYWORDS = dict(decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True, centered=False,
                    momentum=None, nesterov=False, bias_correction=False)

    def updates(self, group, ps, gs, states, count):
        d, eps = group["decay"], group["eps"]
        nus = _state(states, ps, "nu", group["initial_scale"])
        _moment(nus, gs, d, 2)
        fix = 1 - d**count if group["bias_correction"] else 1.0
        var = _scaled(nus, 1 / fix)
        if group["centered"]:
            mus = _state(states, ps, "mu")
            _moment(mus, gs, d, 1)
            mu_hat = _scaled(mus, 1 / fix)
            torch._foreach_addcmul_(var, mu_hat, mu_hat, value=-1)
        if group["eps_in_sqrt"]:
            torch._foreach_add_(var, eps)
            scale = torch._foreach_rsqrt(var)
        else:
            torch._foreach_sqrt_(var)
            torch._foreach_add_(var, eps)
            scale = torch._foreach_reciprocal(var)
        us = _scaled(torch._foreach_mul(scale, gs), -group["lr"])
        if group["momentum"] is not None:
            us = _trace(states, ps, us, group["momentum"], group["nesterov"])
        return us


class Adagrad(OptaxOptimizer):
    KEYWORDS = dict(initial_accumulator_value=0.1, eps=1e-7)

    def updates(self, group, ps, gs, states, count):
        sums = _state(states, ps, "sum_of_squares", group["initial_accumulator_value"])
        torch._foreach_addcmul_(sums, gs, gs)
        inv = [torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0) for s in sums]
        return _scaled(torch._foreach_mul(inv, gs), -group["lr"])


class Adadelta(OptaxOptimizer):
    KEYWORDS = dict(rho=0.9, eps=1e-6, weight_decay=0.0)
    MASKS = dict(weight_decay_mask=None)

    def updates(self, group, ps, gs, states, count):
        rho, eps = group["rho"], group["eps"]
        gs = self.decayed("weight_decay_mask", gs, ps, group["weight_decay"])
        e_g, e_x = _state(states, ps, "e_g"), _state(states, ps, "e_x")
        _moment(e_g, gs, rho, 2)
        num = torch._foreach_sqrt(torch._foreach_add(e_x, eps))
        den = torch._foreach_sqrt(torch._foreach_add(e_g, eps))
        us = torch._foreach_mul(torch._foreach_div(num, den), gs)
        _moment(e_x, us, rho, 2)
        return _scaled(us, -group["lr"])


def _adam_direction(group, ps, gs, states, count, mu_dtype=None, nesterov=False) -> list:
    """optax's ``scale_by_adam``: m̂ / (√(v̂ + ε_root) + ε), the first moment
    stored in ``mu_dtype``."""
    b1, b2 = group["b1"], group["b2"]
    mus = _stored_moment(states, ps, gs, "mu", b1, mu_dtype)
    nus = _state(states, ps, "nu")
    _moment(nus, gs, b2, 2)
    den = _scaled(nus, 1 / (1 - b2**count))
    torch._foreach_add_(den, group["eps_root"])
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, group["eps"])
    return torch._foreach_div(_mu_hat(mus, gs, b1, count, nesterov), den)


class Adam(OptaxOptimizer):
    """optax's ``adam``, where a keyword ``torch.optim.Adam`` does not
    compute is set (``trainer.make_optimizer``)."""

    KEYWORDS = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, nesterov=False)
    DTYPES = dict(mu_dtype=None)

    def updates(self, group, ps, gs, states, count):
        us = _adam_direction(group, ps, gs, states, count, self.dtypes["mu_dtype"],
                             group["nesterov"])
        if "weight_decay" in group:  # adamw
            us = self.decayed("mask", us, ps, group["weight_decay"])
        return _scaled(us, -group["lr"])


class AdamW(Adam):
    """optax's ``adamw``: Adam's direction plus the decayed weights on the
    leaves ``mask`` selects."""

    KEYWORDS = dict(Adam.KEYWORDS, weight_decay=1e-4)
    MASKS = dict(mask=None)


class RAdam(OptaxOptimizer):
    KEYWORDS = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, threshold=5.0, nesterov=False)

    def updates(self, group, ps, gs, states, count):
        b1, b2 = group["b1"], group["b2"]
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2**count
        ro = ro_inf - 2 * count * b2t / (1 - b2t)
        mus, nus = _state(states, ps, "mu"), _state(states, ps, "nu")
        _moment(mus, gs, b1, 1)
        _moment(nus, gs, b2, 2)
        mu_hat = _mu_hat(mus, gs, b1, count, group["nesterov"])
        if ro < group["threshold"]:
            return _scaled(mu_hat, -group["lr"])
        r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        den = _scaled(nus, 1 / (1 - b2t))
        torch._foreach_add_(den, group["eps_root"])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        return _scaled(torch._foreach_div(mu_hat, den), -group["lr"] * r)


class Yogi(OptaxOptimizer):
    KEYWORDS = dict(b1=0.9, b2=0.999, eps=1e-3)

    def updates(self, group, ps, gs, states, count):
        b1, b2 = group["b1"], group["b2"]
        mus, nus = _state(states, ps, "mu", 1e-6), _state(states, ps, "nu", 1e-6)
        _moment(mus, gs, b1, 1)
        for v, g in zip(nus, gs):
            g2 = g * g
            v.sub_((1 - b2) * torch.sign(v - g2) * g2)
        den = torch._foreach_sqrt(_scaled(nus, 1 / (1 - b2**count)))
        torch._foreach_add_(den, group["eps"])
        return _scaled(torch._foreach_div(_scaled(mus, 1 / (1 - b1**count)), den), -group["lr"])


class AdaBelief(OptaxOptimizer):
    KEYWORDS = dict(b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16, nesterov=False)

    def updates(self, group, ps, gs, states, count):
        b1, b2 = group["b1"], group["b2"]
        mus, nus = _state(states, ps, "mu"), _state(states, ps, "nu")
        _moment(mus, gs, b1, 1)
        _moment(nus, torch._foreach_sub(gs, mus), b2, 2)
        torch._foreach_add_(nus, group["eps_root"])
        mu_hat = _mu_hat(mus, gs, b1, count, group["nesterov"])
        den = torch._foreach_sqrt(_scaled(nus, 1 / (1 - b2**count)))
        torch._foreach_add_(den, group["eps"])
        return _scaled(torch._foreach_div(mu_hat, den), -group["lr"])


class Lion(OptaxOptimizer):
    KEYWORDS = dict(b1=0.9, b2=0.99, weight_decay=1e-3)
    MASKS = dict(mask=None)
    DTYPES = dict(mu_dtype=None)

    def updates(self, group, ps, gs, states, count):
        b1, dtype = group["b1"], self.dtypes["mu_dtype"]
        mus = [m.to(g.dtype) for m, g in zip(_state(states, ps, "mu", dtype=dtype), gs)]
        us = torch._foreach_sign(torch._foreach_add(_scaled(gs, 1.0 - b1), _scaled(mus, b1)))
        _stored_moment(states, ps, gs, "mu", group["b2"], dtype)
        us = self.decayed("mask", us, ps, group["weight_decay"])
        return _scaled(us, -group["lr"])


# --- the layerwise four: statistics over each flax leaf ---------------------------


def _trust_ratio(u: torch.Tensor, p: torch.Tensor, coefficient: float, eps: float):
    """optax's ``scale_by_trust_ratio`` on one leaf (``min_norm`` 0): the
    ratio c·‖p‖/(‖u‖ + ε), or 1 where either norm is 0."""
    pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
    ratio = coefficient * pn / (un + eps)
    return torch.where((pn == 0) | (un == 0), torch.ones_like(ratio), ratio)


class _Layerwise(OptaxOptimizer):
    def per_leaf(self, flat_u, flat_p, fn) -> torch.Tensor:
        """``fn(i, u_leaf, p_leaf)`` on each leaf in its flax shape, scattered
        back; elements of no leaf get 0."""
        out = torch.zeros_like(flat_u)
        for i, (_, shape, idx) in enumerate(self.leaves(flat_u.device)):
            out[idx] = fn(i, flat_u[idx].reshape(shape), flat_p[idx].reshape(shape)).reshape(-1)
        return out


class Lamb(_Layerwise):
    KEYWORDS = dict(b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0, weight_decay=0.0)
    MASKS = dict(mask=None)

    def updates(self, group, ps, gs, states, count):
        us = _adam_direction(group, ps, gs, states, count)
        us = self.decayed("mask", us, ps, group["weight_decay"])
        flat = self.per_leaf(_join(us), _join(ps),
                             lambda i, u, p: u * _trust_ratio(u, p, 1.0, 0.0))
        return self.split(flat * -group["lr"], ps)


class Lars(_Layerwise):
    KEYWORDS = dict(weight_decay=0.0, trust_coefficient=0.001, eps=0.0, momentum=0.9,
                    nesterov=False)
    MASKS = dict(weight_decay_mask=True, trust_ratio_mask=True)

    def updates(self, group, ps, gs, states, count):
        us = self.decayed("weight_decay_mask", gs, ps, group["weight_decay"])
        c, eps, on = group["trust_coefficient"], group["eps"], self.masks["trust_ratio_mask"]
        flat = self.per_leaf(_join(us), _join(ps), lambda i, u, p: u * _trust_ratio(u, p, c, eps)
                             if on is None or on[i] else u)
        us = self.split(flat * -group["lr"], ps)
        return _trace(states, ps, us, group["momentum"], group["nesterov"])


class NovoGrad(_Layerwise):
    KEYWORDS = dict(b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0, weight_decay=0.0)

    def updates(self, group, ps, gs, states, count):
        b1, b2 = group["b1"], group["b2"]
        flat_g, flat_p = _join(gs), _join(ps)
        n = len(self.leaf_map.leaves)
        nu = self.state.get("leaf_nu")
        if nu is None:
            nu = torch.zeros(n, dtype=flat_g.dtype, device=flat_g.device)
        new_nu = torch.empty_like(nu)

        def direction(i, g, p):
            sq = torch.linalg.vector_norm(g) ** 2
            new_nu[i] = sq if count == 1 else (1 - b2) * sq + b2 * nu[i]
            return g / (torch.sqrt(new_nu[i] + group["eps_root"]) + group["eps"]) \
                + group["weight_decay"] * p

        step = self.split(self.per_leaf(flat_g, flat_p, direction), ps)
        self.state["leaf_nu"] = new_nu
        mus = _state(states, ps, "mu")
        if count > 1:
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, step)
        else:
            torch._foreach_copy_(mus, step)
        return _scaled(mus, -group["lr"])


class Adafactor(_Layerwise):
    KEYWORDS = dict(min_dim_size_to_factor=128, decay_rate=0.8, decay_offset=0,
                    multiply_by_parameter_scale=True, clipping_threshold=1.0, momentum=None,
                    weight_decay_rate=None, eps=1e-30, factored=True)
    MASKS = dict(weight_decay_mask=None)
    DTYPES = dict(dtype_momentum="float32")

    @staticmethod
    def factored_dims(shape, factored: bool, min_dim: int):
        """optax's ``_factored_dims``: the two largest axes, when both reach
        ``min_dim``."""
        if not factored or len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < min_dim:
            return None
        return int(order[-2]), int(order[-1])

    def updates(self, group, ps, gs, states, count):
        # optax's decay schedule, 1 − (t + 1)^(−decay_rate) at its count t
        # before this step, computed in float32 as optax does.
        t = float(np.float32(count - 1 - group["decay_offset"] + 1))
        rate = float(np.float32(1.0) - np.float32(t) ** np.float32(-group["decay_rate"]))
        eps, lr = group["eps"], group["lr"]
        dtype, decay = self.dtypes["dtype_momentum"], self.masks["weight_decay_mask"]

        def update(i, g, p):
            st = self.state.setdefault(f"leaf{i}", {})
            dims = self.factored_dims(tuple(g.shape), group["factored"],
                                      group["min_dim_size_to_factor"])
            sq = g * g + eps
            if dims is not None:
                d1, d0 = dims
                v_row = st.get("v_row", torch.zeros_like(sq.mean(dim=d0)))
                v_col = st.get("v_col", torch.zeros_like(sq.mean(dim=d1)))
                st["v_row"] = v_row = rate * v_row + (1.0 - rate) * sq.mean(dim=d0)
                st["v_col"] = v_col = rate * v_col + (1.0 - rate) * sq.mean(dim=d1)
                reduced = d1 - 1 if d1 > d0 else d1
                row = (v_row / v_row.mean(dim=reduced, keepdim=True)) ** -0.5
                u = g * row.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            else:
                v = st.get("v", torch.zeros_like(sq))
                st["v"] = v = rate * v + (1.0 - rate) * sq
                u = g * v ** -0.5
            if group["clipping_threshold"] is not None:
                u = u / torch.clamp(torch.sqrt((u * u).mean()) / group["clipping_threshold"],
                                    min=1.0)
            u = u * lr
            if group["multiply_by_parameter_scale"]:
                rms = torch.sqrt((p * p).mean())
                u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
            if group["momentum"] is not None:
                m = st.get("ema", torch.zeros_like(u, dtype=dtype)).to(u.dtype)
                u = _complement(group["momentum"]) * u + group["momentum"] * m
                st["ema"] = u.to(dtype)
            if group["weight_decay_rate"] is not None and (decay is None or decay[i]):
                u = u + group["weight_decay_rate"] * p
            return -u

        return self.split(self.per_leaf(_join(gs), _join(ps), update), ps)


OPTIMIZERS = {"adam": Adam, "adamw": AdamW, "sgd": SGD, "rmsprop": RMSProp, "adagrad": Adagrad,
              "adadelta": Adadelta, "lamb": Lamb, "lars": Lars, "radam": RAdam,
              "adafactor": Adafactor, "novograd": NovoGrad, "yogi": Yogi, "adabelief": AdaBelief,
              "lion": Lion}
LAYERWISE = ("lamb", "lars", "novograd", "adafactor")
