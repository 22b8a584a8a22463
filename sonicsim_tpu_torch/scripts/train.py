"""Train a model from a YAML config, data-parallel over every card.

  python -m sonicsim_tpu_torch.scripts.train --conf_dir configs/separation/convtasnet.yaml \\
      [--max_epochs N] [--resume] [--device cpu]

Port of scripts/train.py (reference separation/train.py:28-126): load the
YAML (the repo's, unchanged: its ``sonicsim_tpu.…`` targets build the
port's classes), instantiate the datamodule, model, loss and metric, fit,
snapshot the config and export ``<exp>/best_model.pkl`` in the JAX
package's pack format. ``trainer.precision`` (``f32``/``bf16``) comes from
the config. The model trains on the card unless ``--device`` names another,
and, as the JAX script trains over every device, ``Trainer`` spreads each
batch over every card of the host that divides it (``parallel.mesh``); on
the CPU it trains on the one CPU. Its initial weights are drawn on the host
from ``torch.manual_seed(0)``, as the JAX script draws its own from
``PRNGKey(0)``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..bridge import resolve_device
from ..train import Trainer
from ..utils import instantiate, load_config, save_config

INIT_SEED = 0


def train_from_config(cfg: dict, device=None, max_epochs: int | None = None,
                      resume: bool = False) -> Trainer:
    """Fit the config's model on its datamodule, on ``device`` (the card
    unless given), into ``<exp.dir>/<exp.name>``. Returns the trainer, whose
    ``model`` holds the final weights."""
    device = resolve_device(device)
    exp_dir = Path(cfg["exp"]["dir"]) / cfg["exp"]["name"]
    datamodule = instantiate(cfg["datas"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(INIT_SEED)
        model = instantiate(cfg["model"], device=device)
    loss_fn = instantiate(cfg["loss"])
    metric_fn = instantiate(cfg["metrics"]) if "metrics" in cfg else loss_fn

    tcfg = cfg.get("trainer", {})
    ocfg = cfg.get("optimizer", {})
    scfg = cfg.get("scheduler", {})
    trainer = Trainer(
        model=model,
        loss_fn=loss_fn,
        metric_fn=metric_fn,
        lr=float(ocfg.get("lr", 1e-3)),
        weight_decay=float(ocfg.get("weight_decay", 0.0)),
        clip_norm=tcfg.get("gradient_clip_val", 5.0),
        max_epochs=max_epochs or int(tcfg.get("max_epochs", 500)),
        patience_lr=int(scfg.get("patience", 10)),
        lr_factor=float(scfg.get("factor", 0.5)),
        patience_stop=int(cfg.get("early_stopping", {}).get("patience", 20)),
        save_top_k=int(cfg.get("checkpoint", {}).get("save_top_k", 5)),
        precision=str(tcfg.get("precision", "f32")),
        exp_dir=exp_dir,
    )
    crop = int(datamodule.sample_rate * datamodule.duration)
    trainer.fit(datamodule.train_batches, lambda: datamodule.val_batches(crop=crop),
                resume=resume)
    return trainer


def main(argv: list[str] | None = None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--conf_dir", required=True, help="path to the YAML config")
    ap.add_argument("--max_epochs", type=int, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="continue from <exp>/checkpoints/last (full state: "
                    "weights, optimizer, schedulers, top-k)")
    ap.add_argument("--device", default=None,
                    help="default: the card; cpu for the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(args.conf_dir)
    exp_dir = Path(cfg["exp"]["dir"]) / cfg["exp"]["name"]
    exp_dir.mkdir(parents=True, exist_ok=True)
    save_config(cfg, exp_dir / "config.yaml")  # snapshot (train.py:121-124)
    train_from_config(cfg, device, args.max_epochs, args.resume)
    best = exp_dir / "best_model.pkl"
    print(f"training done; best model at {best}")
    return best


if __name__ == "__main__":
    main()
