"""optax's optimizers as ``torch.optim.Optimizer`` subclasses.

Port of the optimizer zoo behind ``sonicsim_tpu.train.trainer
.make_optimizer`` (the reference's look2hear/system/optimizers.py:8-113 on
optax): sgd, rmsprop, adagrad, adadelta, lamb, lars, radam, adafactor,
novograd, yogi, adabelief and lion. Each computes optax 0.2.6's arithmetic
under optax's defaults, term by term, not PyTorch's nearest optimizer
(``torch.optim.RMSprop`` takes g/(√ν + ε), optax's ``rmsprop`` g/√(ν + ε);
``Adagrad`` starts its sum at 0, optax's at 0.1; …). Each takes the optax
function's keyword names and raises ``TypeError`` on any other, as the
optax function does. ``lr`` in ``param_groups`` is optax's injected
``learning_rate`` (``trainer.set_learning_rate``).

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
    its elements some leaf holds}, where that is not every element."""

    params: list
    leaves: list
    masks: dict = field(default_factory=dict)


def tensor_leaf_map(params) -> LeafMap:
    """Each tensor of ``params`` its own leaf."""
    params = [p for p in params if p.requires_grad]
    leaves, start = [], 0
    for i, p in enumerate(params):
        leaves.append((str(i), tuple(p.shape), torch.arange(start, start + p.numel())))
        start += p.numel()
    return LeafMap(params, leaves)


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
    return LeafMap([p for _, p in named], leaves, masks)


def _join(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


class OptaxOptimizer(torch.optim.Optimizer):
    """One optax optimizer over a :class:`LeafMap`'s tensors. A subclass
    names its optax keywords and their defaults (``KEYWORDS``) and those it
    takes at their default only (``FIXED``: dtypes and masks), and computes
    :meth:`updates`: the update each tensor's elements are moved by
    (optax's ``updates``, added to the parameters)."""

    KEYWORDS: dict = {}
    FIXED: dict = {}

    def __init__(self, leaf_map: LeafMap, lr: float, **kwargs):
        name = type(self).__name__.lower()
        for k in kwargs:
            if k not in self.KEYWORDS and k not in self.FIXED:
                raise TypeError(f"{name}() got an unexpected keyword argument {k!r}")
        for k, v in kwargs.items():
            if k in self.FIXED and not _is_default(v, self.FIXED[k]):
                raise NotImplementedError(f"{name}({k}={v!r}): the port takes {k} at its "
                                          f"default, {self.FIXED[k]!r}")
        defaults = dict(self.KEYWORDS, **{k: v for k, v in kwargs.items() if k in self.KEYWORDS})
        super().__init__(leaf_map.params, dict(lr=lr, **defaults))
        self.leaf_map = leaf_map
        self._index: dict = {}

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


def _is_default(v, default) -> bool:
    if default == "float32":
        return v is None or v in ("float32", torch.float32, np.float32)
    return v is default or v == default


def _moment(ms, gs, decay: float, order: int = 1):
    """optax's ``update_moment``: m ← (1 − decay)·gᵒʳᵈᵉʳ + decay·m, in place."""
    torch._foreach_mul_(ms, decay)
    if order == 1:
        torch._foreach_add_(ms, gs, alpha=1 - decay)
    else:
        torch._foreach_addcmul_(ms, gs, gs, value=1 - decay)


def _state(states, ps, key: str, fill: float = 0.0) -> list:
    for s, p in zip(states, ps):
        if key not in s:
            s[key] = torch.full_like(p, fill, memory_format=torch.preserve_format)
    return [s[key] for s in states]


def _scaled(ts, s: float) -> list:
    return torch._foreach_mul(ts, s)


def _trace(states, ps, us, decay: float, nesterov: bool) -> list:
    """optax's ``trace``: t ← u + decay·t; the update t, or u + decay·t with
    Nesterov."""
    ts = _state(states, ps, "trace")
    torch._foreach_mul_(ts, decay)
    torch._foreach_add_(ts, us)
    return torch._foreach_add(us, _scaled(ts, decay)) if nesterov else [t.clone() for t in ts]


class SGD(OptaxOptimizer):
    KEYWORDS = dict(momentum=None, nesterov=False)
    FIXED = dict(accumulator_dtype=None)

    def updates(self, group, ps, gs, states, count):
        us = list(gs)
        if group["momentum"] is not None:
            us = _trace(states, ps, us, group["momentum"], group["nesterov"])
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
    FIXED = dict(weight_decay_mask=None)

    def updates(self, group, ps, gs, states, count):
        rho, eps = group["rho"], group["eps"]
        gs = torch._foreach_add(gs, ps, alpha=group["weight_decay"])
        e_g, e_x = _state(states, ps, "e_g"), _state(states, ps, "e_x")
        _moment(e_g, gs, rho, 2)
        num = torch._foreach_sqrt(torch._foreach_add(e_x, eps))
        den = torch._foreach_sqrt(torch._foreach_add(e_g, eps))
        us = torch._foreach_mul(torch._foreach_div(num, den), gs)
        _moment(e_x, us, rho, 2)
        return _scaled(us, -group["lr"])


def _adam_direction(group, ps, gs, states, count) -> list:
    """optax's ``scale_by_adam`` (without Nesterov): m̂ / (√(v̂ + ε_root) + ε)."""
    b1, b2 = group["b1"], group["b2"]
    mus, nus = _state(states, ps, "mu"), _state(states, ps, "nu")
    _moment(mus, gs, b1, 1)
    _moment(nus, gs, b2, 2)
    den = _scaled(nus, 1 / (1 - b2**count))
    torch._foreach_add_(den, group["eps_root"])
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, group["eps"])
    return torch._foreach_div(_scaled(mus, 1 / (1 - b1**count)), den)


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
        if group["nesterov"]:
            mu_hat = torch._foreach_add(_scaled(mus, b1 / (1 - b1**(count + 1))),
                                        _scaled(gs, (1 - b1) / (1 - b1**count)))
        else:
            mu_hat = _scaled(mus, 1 / (1 - b1**count))
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
        if group["nesterov"]:
            mu_hat = torch._foreach_add(_scaled(mus, b1 / (1 - b1**(count + 1))),
                                        _scaled(gs, (1 - b1) / (1 - b1**count)))
        else:
            mu_hat = _scaled(mus, 1 / (1 - b1**count))
        den = torch._foreach_sqrt(_scaled(nus, 1 / (1 - b2**count)))
        torch._foreach_add_(den, group["eps"])
        return _scaled(torch._foreach_div(mu_hat, den), -group["lr"])


class Lion(OptaxOptimizer):
    KEYWORDS = dict(b1=0.9, b2=0.99, weight_decay=1e-3)
    FIXED = dict(mu_dtype=None, mask=None)

    def updates(self, group, ps, gs, states, count):
        b1 = group["b1"]
        mus = _state(states, ps, "mu")
        us = torch._foreach_sign(torch._foreach_add(_scaled(gs, 1.0 - b1), _scaled(mus, b1)))
        _moment(mus, gs, group["b2"], 1)
        torch._foreach_add_(us, ps, alpha=group["weight_decay"])
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
    FIXED = dict(mask=None)

    def updates(self, group, ps, gs, states, count):
        us = _adam_direction(group, ps, gs, states, count)
        torch._foreach_add_(us, ps, alpha=group["weight_decay"])
        flat = self.per_leaf(_join(us), _join(ps),
                             lambda i, u, p: u * _trust_ratio(u, p, 1.0, 0.0))
        return self.split(flat * -group["lr"], ps)


class Lars(_Layerwise):
    KEYWORDS = dict(weight_decay=0.0, trust_coefficient=0.001, eps=0.0, momentum=0.9,
                    nesterov=False)
    FIXED = dict(weight_decay_mask=True, trust_ratio_mask=True)

    def updates(self, group, ps, gs, states, count):
        us = torch._foreach_add(gs, ps, alpha=group["weight_decay"])
        c, eps = group["trust_coefficient"], group["eps"]
        flat = self.per_leaf(_join(us), _join(ps), lambda i, u, p: u * _trust_ratio(u, p, c, eps))
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
    FIXED = dict(dtype_momentum="float32", weight_decay_mask=None)

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
                m = st.get("ema", torch.zeros_like(u))
                st["ema"] = u = (1 - group["momentum"]) * u + group["momentum"] * m
            if group["weight_decay_rate"] is not None:
                u = u + group["weight_decay_rate"] * p
            return -u

        return self.split(self.per_leaf(_join(gs), _join(ps), update), ps)


OPTIMIZERS = {"sgd": SGD, "rmsprop": RMSProp, "adagrad": Adagrad, "adadelta": Adadelta,
              "lamb": Lamb, "lars": Lars, "radam": RAdam, "adafactor": Adafactor,
              "novograd": NovoGrad, "yogi": Yogi, "adabelief": AdaBelief, "lion": Lion}
LAYERWISE = ("lamb", "lars", "novograd", "adafactor")
