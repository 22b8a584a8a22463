"""Host-side LR controllers (a copy of ``sonicsim_tpu.train.schedulers``).

Plain Python, as in the JAX package, so the LR and stop sequences are the
JAX package's by construction. Parity targets: torch ReduceLROnPlateau as
configured by the reference
(configs/convtasnet.yaml scheduler: patience 10, factor 0.5; applied on
val_loss in audio_litmodule.py:160-185) and the DPTNet warmup/decay schedule
(look2hear/system/schedulers.py:59-128).

The LR is a host value that ``train.trainer.set_learning_rate`` writes into
the optimizer's ``param_groups`` between epochs.
"""

from __future__ import annotations

import math


class ReduceLROnPlateau:
    def __init__(
        self,
        lr: float,
        factor: float = 0.5,
        patience: int = 10,
        min_lr: float = 0.0,
        mode: str = "min",
        threshold: float = 1e-4,
    ):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.mode = mode
        self.threshold = threshold
        self.best = math.inf if mode == "min" else -math.inf
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        # torch parity: relative threshold (default 1e-4) — float-noise
        # creep does NOT count as improvement, so a slow plateau still
        # decays the LR (torch threshold_mode='rel').
        improved = (
            metric < self.best * (1.0 - self.threshold)
            if self.mode == "min"
            else metric > self.best * (1.0 + self.threshold)
        )
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


class DPTNetScheduler:
    """Step-wise warmup then exponential decay (schedulers.py:59-128)."""

    def __init__(
        self,
        d_model: int = 64,
        warmup_steps: int = 4000,
        noam_scale: float = 1.0,
        exp_max: float = 0.0004,
        exp_base: float = 0.98,
        steps_per_epoch: int = 10000,
    ):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        self.noam_scale = noam_scale
        self.exp_max = exp_max
        self.exp_base = exp_base
        self.steps_per_epoch = steps_per_epoch
        self.step_num = 0

    def step(self) -> float:
        self.step_num += 1
        if self.step_num <= self.warmup_steps:
            return (
                self.noam_scale
                * self.d_model**-0.5
                * self.step_num
                * self.warmup_steps**-1.5
            )
        epoch = self.step_num // self.steps_per_epoch
        return self.exp_max * self.exp_base ** ((epoch - 1) // 2)


class CustomExponentialLR:
    """Stepped exponential decay (schedulers.py:115-125).

    Faithful to the upstream quirk: ``get_lr`` multiplies the ORIGINAL
    base lr by gamma (never compounding), so the lr drops to
    ``base*gamma`` at the first ``step_size`` boundary and holds there —
    it never returns to ``base`` and never decays further. Torch fires
    the drop when ``(last_epoch + 1) % step_size == 0``, i.e. on call
    number ``step_size - 1``; matched here. Unused by any shipped
    config; kept for drop-in parity.
    """

    def __init__(self, lr: float, gamma: float, step_size: int):
        self.base_lr = lr
        self.lr = lr
        self.gamma = gamma
        self.step_size = step_size
        self.last_epoch = 0

    def step(self) -> float:
        # torch increments last_epoch, then applies get_lr: the drop
        # fires on user call number step_size - 1.
        self.last_epoch += 1
        if self.last_epoch != 0 and (self.last_epoch + 1) % self.step_size == 0:
            self.lr = self.base_lr * self.gamma
        return self.lr


class EarlyStopping:
    """Patience-based stop signal (configs/convtasnet.yaml early_stopping)."""

    def __init__(self, patience: int = 20, mode: str = "min"):
        self.patience = patience
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.bad_epochs = 0

    def step(self, metric: float) -> bool:
        improved = metric < self.best if self.mode == "min" else metric > self.best
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        # Lightning parity: stop when wait_count REACHES patience
        # (>=), i.e. after the patience-th non-improving epoch.
        return self.bad_epochs >= self.patience
