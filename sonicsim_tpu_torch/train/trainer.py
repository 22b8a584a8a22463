"""Training: the train step and the epoch loop, on one device or a mesh.

Port of ``sonicsim_tpu.train.trainer`` (the reference's
AudioLightningModule + pl.Trainer, audio_litmodule.py:36-211,
train.py:28-109). The step computes the JAX package's function (optax
``clip_by_global_norm`` then the named optax optimizer behind an injected
LR) term by term, not PyTorch's nearest calls:

* **Clipping** is optax's: ``g_norm = sqrt(Σ_leaves Σ g²)``; below
  ``max_norm`` the gradients pass unchanged, else each becomes
  ``(g / g_norm)·max_norm``. ``torch.nn.utils.clip_grad_norm_`` scales by
  ``max_norm/(norm + 1e-6)`` and is not that function.
* **Optimizer.** optax ``adam`` is ``torch.optim.Adam(lr, (0.9, 0.999),
  eps=1e-8)``. The JAX factory turns ``adam`` with a weight decay into
  optax ``adamw`` (decoupled decay), which is ``torch.optim.AdamW``;
  ``Adam(weight_decay=)`` would be L2 regularisation instead. With a
  keyword torch's have no counterpart for (``eps_root``, ``mu_dtype``,
  ``nesterov``, adamw's ``mask``) they are ``train.optim``'s ports of
  optax's functions, as are the other twelve names.
* **bf16** casts the state the bridge maps inside the step
  (``infer.precision.cast_state``, a differentiable ``.to``, the cast
  ``bf16_forward`` takes) and runs the model through
  ``torch.func.functional_call`` on a bf16 input; the estimates reach the
  loss as the JAX step's ``jnp.asarray(ests, jnp.float32)`` makes them: one
  float32 tensor, a list or tuple of same-shape outputs stacked on a new
  first axis (the GaGNet family's stage spectra). Where that call raises in
  the JAX package (outputs of mixed shapes), the port refuses bf16 training
  by name (``precision.BF16_TRAIN_REFUSED``). Gradients reach the float32
  master weights through the cast, and Adam's state stays float32.

The model is an ``nn.Module``, and ``Trainer.fit`` trains the weights it
holds on the device they are on, so both packages can start from the same
weights through ``bridge``.

**Data parallelism** (``mesh=``; ``Trainer(n_devices)``) computes the
function GSPMD computes for the JAX step under a mesh, not DDP's: the
batch is sharded over the mesh, the replicas of the model
(``parallel.mesh.replicate``: the primary's parameters, copied where the
device differs) run at once, a batch-statistics norm reduces over the
global batch, and the loss is computed once, on the outputs gathered on the
mesh's first device. One backward then sums every replica's gradient into
the primary parameters, where the clip, the optimizer, a ``bias_hh`` hook
and a checkpoint see one model. The mean of per-shard losses would be
another function for PIT's ``threshold_byloss`` (a masked mean over the
whole batch).

The resume point is ``torch.save`` of the model and optimizer state in
place of orbax; the logs, checkpoints and the ``best_model.pkl`` export
keep the JAX package's formats.
"""

from __future__ import annotations

import itertools
import json
import logging
import math
import os
import shutil
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn as nn

from ..infer.precision import bf16_call, cast_state, require_bf16
from ..models.base import BaseModel, save_model
from ..parallel.mesh import Mesh, available_devices, data_parallel
from .schedulers import EarlyStopping, ReduceLROnPlateau

logger = logging.getLogger(__name__)

# The JAX factory's optimizer names (optax): adam and adamw are torch's Adam
# and AdamW (``train.optim``'s where a keyword torch's lack is set), the
# other twelve ``train.optim``'s.
_OPTAX_NAMES = ("adam", "adamw", "sgd", "rmsprop", "adagrad", "adadelta", "lamb",
                "lars", "radam", "adafactor", "novograd", "yogi", "adabelief", "lion")
_OPTAX_ADAMW_DECAY = 1e-4  # optax.adamw's default, where the config sets none
# optax.adam(w)'s keywords that torch's Adam(W) computes. With these alone
# adam is torch's: the same function as ``optim.Adam`` up to rounding, and
# a shorter step on the card (PERF.md §6, ``chip_smoke.py --profile --only
# train-``).
_ADAM_KEYWORDS = ("b1", "b2", "eps")


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(model, lr: float = 1e-3, weight_decay: float = 0.0, name: str = "adam",
                   **kwargs) -> torch.optim.Optimizer:
    """The JAX factory's ``name`` optimizer (sonicsim_tpu/train/trainer.py:
    42-84) over ``model`` (a zoo model, whose flax leaves the layerwise
    optimizers take their statistics over, ``optim.flax_leaf_map``) or a
    bare parameter list (each tensor one leaf), its LR in ``param_groups``
    (:func:`set_learning_rate`). As in the JAX factory, ``adam`` with a
    weight decay is ``adamw``; ``weight_decay`` reaches the optimizers whose
    optax function takes it (adamw, adadelta, lamb, lars, novograd, lion),
    and where it is 0 they keep optax's default (adamw 1e-4, lion 1e-3, the
    others 0); ``kwargs`` are the optax function's keywords, masks
    evaluated on the model's flax tree (``optim.leaf_selection``). Adam(W)
    is torch's where ``kwargs`` name only ``b1``, ``b2`` and ``eps``, else
    ``optim.Adam(W)``. Clipping is the train step's
    (:func:`make_train_step`)."""
    from ..models.base import _FLAX_LAYOUT
    from . import optim

    key = name.lower()
    if key not in _OPTAX_NAMES:
        raise KeyError(f"unknown optimizer {name!r}; known: {sorted(_OPTAX_NAMES)}")
    if weight_decay and key == "adam":
        key = "adamw"
    zoo = isinstance(model, nn.Module) and type(model).__name__.lower() in _FLAX_LAYOUT
    params = list(model.parameters() if isinstance(model, nn.Module) else model)
    if key in ("adam", "adamw") and set(kwargs) <= set(_ADAM_KEYWORDS):
        betas = (kwargs.get("b1", 0.9), kwargs.get("b2", 0.999))
        eps = kwargs.get("eps", 1e-8)
        if key == "adam":
            return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                 weight_decay=weight_decay or _OPTAX_ADAMW_DECAY)
    cls = optim.OPTIMIZERS[key]
    if weight_decay and "weight_decay" in cls.KEYWORDS:
        kwargs["weight_decay"] = weight_decay
    leaf_map = optim.flax_leaf_map(model) if zoo else optim.tensor_leaf_map(params)
    return cls(leaf_map, lr, **kwargs)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on ``grads``, in place, with no wait
    on the device: ``g_norm = sqrt(Σ_leaves ‖g‖²)``; below ``max_norm``
    every gradient stays as it is (divided and multiplied by 1), else each
    becomes ``(g / g_norm)·max_norm``. The ``_foreach`` calls keep it to a
    few launches for all the leaves. Returns the global norm before
    clipping."""
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = g_norm < max_norm
    one = torch.ones_like(g_norm)
    torch._foreach_div_(grads, torch.where(keep, one, g_norm))
    torch._foreach_mul_(grads, torch.where(keep, one, max_norm))
    return g_norm


def _check_mesh(model: nn.Module, mesh: Mesh | None) -> None:
    if mesh is not None and next(model.parameters()).device != mesh.primary:
        raise ValueError(f"the model's weights lie on {next(model.parameters()).device}, "
                         f"the mesh's first device is {mesh.primary}")


def _sharded(model: nn.Module, mesh: Mesh, mix: torch.Tensor, state: dict | None = None):
    """``model(mix)`` over the mesh's replicas, gathered on its first device.
    The batch must divide over the mesh, as a JAX batch sharding needs."""
    if len(mix) % mesh.size:
        raise ValueError(f"a batch of {len(mix)} does not divide over {mesh.size} devices")
    return data_parallel(model, mix, mesh, state)


def make_train_step(model: nn.Module, loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    precision: str = "f32", clip_norm: float | None = 5.0,
                    mesh: Mesh | None = None) -> Callable:
    """``step(mix, targets) -> loss``: one update of ``model``'s weights
    through ``optimizer``, on tensors on the model's device. After a step
    each parameter's ``.grad`` holds the (clipped) gradient the optimizer
    took. With ``mesh`` (whose first device holds the model) the forward
    runs data-parallel over it and the loss is the whole batch's."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unsupported precision {precision!r}")
    if precision == "bf16":
        require_bf16(model, train=True)
    _check_mesh(model, mesh)
    params = list(model.parameters())

    def forward(mix: torch.Tensor) -> torch.Tensor:
        if mesh is not None:
            if precision == "f32":
                return _sharded(model, mesh, mix)
            return stack_float32(_sharded(model, mesh, mix.to(torch.bfloat16),
                                          cast_state(model)))
        if precision == "f32":
            return model(mix)
        return stack_float32(bf16_call(model, cast_state(model), mix))

    def step(mix: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(forward(mix), targets)
        loss.backward()
        if clip_norm is not None:
            clip_by_global_norm([p.grad for p in params if p.grad is not None], clip_norm)
        optimizer.step()
        return loss.detach()

    return step


def stack_float32(ests) -> torch.Tensor:
    """``jnp.asarray(ests, jnp.float32)``: a tensor as float32, a list or
    tuple of same-shape tensors stacked on a new first axis."""
    if isinstance(ests, (tuple, list)):
        return torch.stack([stack_float32(e) for e in ests])
    return ests.to(torch.float32)


def make_eval_step(model: nn.Module, metric_fn: Callable, mesh: Mesh | None = None) -> Callable:
    """``step(mix, targets) -> metric`` without gradients; with ``mesh``,
    the forward data-parallel over it and the metric the whole batch's."""
    _check_mesh(model, mesh)

    def step(mix: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            ests = model(mix) if mesh is None else _sharded(model, mesh, mix)
            return metric_fn(ests, targets)

    return step


def _val_shards(mix, targets, divisor: int):
    """Split a ragged val batch into DP-shardable pieces with exact weights.

    Yields ``(mix, targets, n_real)`` pieces whose per-piece metric means,
    weighted by ``n_real`` and summed, reproduce the real batch's mean
    exactly. The divisor-multiple prefix passes through untouched; only the
    remainder ``r = B % divisor`` is tiled, to ``lcm(r, divisor)`` items
    where every real item appears the same number of times, so the padding
    stays below ``divisor**2`` items. The divisor is the mesh's size (1 on
    one device, where the batch passes whole)."""
    b = len(mix)
    k = (b // divisor) * divisor
    if k:
        yield mix[:k], targets[:k], k
    r = b - k
    if r:
        reps = math.lcm(r, divisor) // r
        yield (
            np.concatenate([mix[k:]] * reps, axis=0),
            np.concatenate([targets[k:]] * reps, axis=0),
            r,
        )


def _to_device(batch, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(batch), device=device)


def _mesh_devices(device: torch.device) -> list:
    """The devices a model on ``device`` can train over: those of its type
    (``parallel.mesh.available_devices``), ``device`` first."""
    devices = available_devices(device.type)
    if device in devices:
        i = devices.index(device)
        devices = devices[i:] + devices[:i]
    return devices


@dataclass
class Trainer:
    """Epoch-driven fit loop with plateau LR, early stop, top-k checkpoints,
    on the device that holds ``model``'s weights and, with ``n_devices``
    (every device of its type by default), data-parallel over as many of
    that type as divide the batch."""

    model: BaseModel
    loss_fn: Callable
    metric_fn: Callable | None = None
    lr: float = 1e-3
    weight_decay: float = 0.0
    clip_norm: float | None = 5.0
    max_epochs: int = 500
    patience_lr: int = 10
    lr_factor: float = 0.5
    patience_stop: int = 20
    save_top_k: int = 5
    exp_dir: str | Path = "Exps/run"
    n_devices: int | None = None
    optimizer_name: str = "adam"
    precision: str = "f32"  # 'bf16': bf16 compute with float32 master weights
    wandb_project: str | None = None  # optional W&B mirror of the JSONL log
    history: list = field(default_factory=list)
    _batch_divisor = 1  # the mesh's size, set by ``fit``

    def _init_wandb(self):
        """The W&B run mirroring ``metrics.jsonl`` (the JAX ``Trainer``'s),
        or None without a project or without ``wandb``."""
        if not self.wandb_project:
            return None
        try:
            import wandb

            return wandb.init(project=self.wandb_project, name=Path(self.exp_dir).name)
        except ImportError:
            return None

    def _val_loss(self, eval_step, batches, device) -> float | None:
        """Weighted mean of the val metric over ``batches``, exact under
        ragged batches: each batch is split by ``_val_shards`` and the
        per-shard means are recombined weighted by real item count."""
        total, n = 0.0, 0
        for m, t in batches:
            for ms, ts, w in _val_shards(np.asarray(m), np.asarray(t), self._batch_divisor):
                v = eval_step(_to_device(ms, device), _to_device(ts, device))
                total += float(v) * w
                n += w
        return (total / n) if n else None

    # ---- full-state checkpointing: weights + optimizer + loop ----
    def _save_last(self, exp_dir: Path, state: TrainState, epoch: int, plateau,
                   stopper, best_k) -> None:
        """Crash-safe resume point: the model's and the optimizer's state
        (``torch.save``) and the loop's (schedulers, early-stop counters,
        top-k table, history), the Lightning ``last.ckpt`` role."""
        last = exp_dir / "checkpoints" / "last"
        last.mkdir(parents=True, exist_ok=True)
        tmp = last / "state.pt.tmp"
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict()}, tmp)
        os.replace(tmp, last / "state.pt")

        def scalars(obj):
            return {k: v for k, v in obj.__dict__.items()
                    if isinstance(v, (int, float, str, bool))}

        # meta.json is the resume commit marker: written last and atomically
        # (tmp + os.replace), so a crash leaves the previous marker whole.
        tmp = last / "meta.json.tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "epoch": epoch,
                    "step": state.step,
                    "plateau": scalars(plateau),
                    "stopper": scalars(stopper),
                    "best_k": best_k,
                    "history": self.history,
                },
                f,
            )
        os.replace(tmp, last / "meta.json")

    def _restore_last(self, exp_dir: Path, state: TrainState, plateau, stopper,
                      device) -> tuple[int, list] | None:
        """Load the resume point into ``state``. → (next epoch, best_k) or
        None where there is none."""
        last = exp_dir / "checkpoints" / "last"
        if not (last / "meta.json").exists():
            return None
        saved = torch.load(last / "state.pt", map_location=device, weights_only=True)
        state.model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        with open(last / "meta.json") as f:
            meta = json.load(f)
        plateau.__dict__.update(meta["plateau"])
        stopper.__dict__.update(meta["stopper"])
        self.history = meta["history"]
        state.step = int(meta["step"])
        logger.info("resuming from epoch %d", meta["epoch"] + 1)
        return int(meta["epoch"]) + 1, [(float(v), p) for v, p in meta["best_k"]]

    def fit(
        self,
        train_batches: Callable[[int], Iterable],
        val_batches: Callable[[], Iterable] | None = None,
        resume: bool = False,
    ) -> TrainState:
        """Train ``model`` from its current weights on numpy batches:
        ``train_batches(epoch)`` yields (mix, targets), ``val_batches()``
        the val set. ``resume=True`` continues from
        <exp_dir>/checkpoints/last (weights, optimizer state, LR-plateau and
        early-stop counters, top-k table) when present and starts fresh
        otherwise. The JAX package's ``fit`` draws its initial weights from
        ``rng``; here the model's constructor made them (seed it there).

        The mesh is sized as the JAX ``fit`` sizes it: the first batch is
        peeked (and chained back into epoch 0, so a single-iterator loader
        keeps it and a factory does not make it twice), and the mesh takes
        the largest device count that divides it, at most ``n_devices``
        (all of the model's device type when None; more than there are is
        clamped, with a warning). Later batches the mesh does not divide are
        dropped, with a warning; val batches are split by ``_val_shards``.
        TF32 is turned off: the step is float32 (or bf16) as the JAX package
        computes it."""
        from ..scripts.common import strict_float32

        strict_float32()
        exp_dir = Path(self.exp_dir)
        (exp_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
        device = next(self.model.parameters()).device

        first_iter = iter(train_batches(0))
        first = next(first_iter, None)
        batch_dim = len(first[0]) if first is not None else 1
        devices = _mesh_devices(device)
        avail = len(devices)
        limit = min(self.n_devices, avail) if self.n_devices else avail
        if self.n_devices and self.n_devices > avail:
            logger.warning("n_devices=%d exceeds available devices (%d); clamping",
                           self.n_devices, avail)
        n_dev = max(d for d in range(1, limit + 1) if batch_dim % d == 0)
        mesh = Mesh(devices[:n_dev]) if n_dev > 1 else None
        logger.info("training over %d of %d %s devices (the most that divide the first "
                    "batch, of %d)", n_dev, avail, device.type, batch_dim)
        self._batch_divisor = n_dev

        wb = self._init_wandb()
        optimizer = make_optimizer(self.model, self.lr, self.weight_decay, self.optimizer_name)
        train_step = make_train_step(self.model, self.loss_fn, optimizer,
                                     self.precision, self.clip_norm, mesh)
        # The val metric defaults to the training loss (the reference's
        # val_loss).
        eval_step = make_eval_step(self.model, self.metric_fn or self.loss_fn, mesh)

        plateau = ReduceLROnPlateau(self.lr, self.lr_factor, self.patience_lr)
        stopper = EarlyStopping(self.patience_stop)
        best_k: list[tuple[float, str]] = []
        state = TrainState(self.model, optimizer)
        start_epoch = 0
        if resume:
            hit = self._restore_last(exp_dir, state, plateau, stopper, device)
            if hit is not None:
                start_epoch, best_k = hit

        if val_batches is not None and start_epoch == 0:
            # Pre-training validation (epoch -1): the untrained baseline
            # every later epoch is compared against.
            t0 = time.time()
            base_loss = self._val_loss(eval_step, val_batches(), device)
            if base_loss is not None:
                rec = {
                    "epoch": -1,
                    "val_loss": base_loss,
                    "lr": self.lr,
                    "seconds": time.time() - t0,
                }
                self.history.append(rec)
                with open(exp_dir / "metrics.jsonl", "a") as f:
                    f.write(json.dumps(rec) + "\n")
                if wb is not None:
                    wb.log(rec)
        dropped_train = 0
        for epoch in range(start_epoch, self.max_epochs):
            t0 = time.time()
            losses = []
            if epoch == 0 and first_iter is not None:
                batches = (itertools.chain([first], first_iter)
                           if first is not None else iter(()))
            else:
                batches = train_batches(epoch)
            first_iter = None
            for mix, targets in batches:
                if len(mix) % self._batch_divisor:
                    # drop_last, but never silently
                    dropped_train += 1
                    if dropped_train <= 3 or epoch == 0:
                        logger.warning("dropping ragged train batch of %d (not divisible by "
                                       "%d devices), epoch %d", len(mix), self._batch_divisor,
                                       epoch)
                    continue
                losses.append(train_step(_to_device(mix, device), _to_device(targets, device)))
                state.step += 1
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")

            val_loss = train_loss
            if val_batches is not None:
                vl = self._val_loss(eval_step, val_batches(), device)
                val_loss = vl if vl is not None else train_loss

            new_lr = plateau.step(val_loss)
            set_learning_rate(optimizer, new_lr)
            rec = {
                "epoch": epoch,
                "train_loss": train_loss,
                "val_loss": val_loss,
                "lr": new_lr,
                "seconds": time.time() - t0,
            }
            self.history.append(rec)
            with open(exp_dir / "metrics.jsonl", "a") as f:
                f.write(json.dumps(rec) + "\n")
            if wb is not None:
                wb.log(rec)

            ckpt = exp_dir / "checkpoints" / f"epoch={epoch}-val_loss={val_loss:.4f}.pkl"
            # NaN/inf epochs never enter top-k: a NaN entry defeats the
            # sort (every comparison is False) and could sit at best_k[0]
            # forever, exporting a diverged best_model.pkl.
            if math.isfinite(val_loss) and (
                len(best_k) < self.save_top_k or val_loss < best_k[-1][0]
            ):
                save_model(self.model, ckpt)
                best_k.append((val_loss, str(ckpt)))
                best_k.sort(key=lambda kv: kv[0])
                for _, stale in best_k[self.save_top_k :]:
                    Path(stale).unlink(missing_ok=True)
                best_k = best_k[: self.save_top_k]
                with open(exp_dir / "best_k_models.json", "w") as f:
                    json.dump({p: v for v, p in best_k}, f, indent=2)

            should_stop = stopper.step(val_loss)
            self._save_last(exp_dir, state, epoch, plateau, stopper, best_k)
            if should_stop:
                break

        # Export the portable best model (train.py:100-105): the best
        # top-k pack as it is, or the final weights when none is finite.
        if best_k:
            shutil.copyfile(best_k[0][1], exp_dir / "best_model.pkl")
        else:
            save_model(self.model, exp_dir / "best_model.pkl")
        return state
