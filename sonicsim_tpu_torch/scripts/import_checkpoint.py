"""Convert a reference torch checkpoint (.pth) to a best_model.pkl pack.

  python -m sonicsim_tpu_torch.scripts.import_checkpoint --in best_model.pth \\
      --out Exps/Conv-TasNet/best_model.pkl [--model ConvTasNet] \\
      [--arg N=512 --arg L=16 ...] [--device cpu]

Port of scripts/import_checkpoint.py, with its flags and rules. The pack
is the JAX package's format (``models.save_model``), so either package
serves it. Without ``--model`` or ``--arg`` the model is built as
``from_pretrain`` builds a reference checkpoint: the constructor's own
arguments of the checkpoint's ``model_args``, and TDANet, DCCRN and FRCRN
in their reference-quirk mode (``torch_compat=True``). With them, the
checkpoint's ``model_args`` but ``n_src`` are kept, each ``--arg k=v``
(an int, else a float, else ``true``/``false``, else a string) overrides
one, and the quirk mode is the default of those three models. The
conversion runs on ``--device``: the card unless it names another, and
without CUDA it raises unless given ``--device cpu``, as the port's other
CLIs do.
"""

from __future__ import annotations

import argparse

import torch

from ..bridge import resolve_device
from ..models import from_pretrain, save_model
from ..models.base import _REFERENCE_ARGS, MODELS


def parse_value(v: str):
    """An ``--arg`` value as scripts/import_checkpoint.py's ``_parse_val``
    reads it."""
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--in", dest="inp", required=True, help="torch .pth pack")
    ap.add_argument("--out", required=True, help="output best_model.pkl")
    ap.add_argument("--model", default=None,
                    help="model class name override (else from the pack)")
    ap.add_argument("--arg", action="append", default=[],
                    help="model kwarg override, e.g. --arg num_spks=2")
    ap.add_argument("--device", default=None,
                    help="where the conversion runs (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.model or args.arg:
        pack = torch.load(args.inp, map_location="cpu", weights_only=True)
        name = args.model or pack.get("model_name", "")
        kwargs = {k: v for k, v in (pack.get("model_args") or {}).items() if k != "n_src"}
        for kv in args.arg:
            k, v = kv.split("=", 1)
            kwargs[k] = parse_value(v)
        for k, v in _REFERENCE_ARGS.get(name.lower(), {}).items():
            kwargs.setdefault(k, v)
        model = MODELS.get(name)(**kwargs, device=device)
        model.load_state_dict({k: torch.as_tensor(v) for k, v in pack["state_dict"].items()})
    else:
        model = from_pretrain(args.inp, device=device)
    save_model(model, args.out)
    line = f"imported {type(model).__name__} -> {args.out}"
    print(line)
    return line


if __name__ == "__main__":
    main()
