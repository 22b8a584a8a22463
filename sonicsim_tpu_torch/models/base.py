"""Model base, registry and portable checkpoints.

Port of ``sonicsim_tpu.models.base`` (reference
separation/look2hear/models/__init__.py:28-60 and base_model.py:29-88).
Models are ``nn.Module``s taking waveforms (B, T) → (B, n_spk, T) and
holding their weights.

Checkpoints are the JAX package's pack format, so a checkpoint from either
package loads in the other: a pickle of ``{"model_name", "model_args",
"state_dict", "framework": "sonicsim_tpu", "version"}`` whose
``state_dict`` is the flax parameter tree as numpy arrays (dicts, arrays
and strings only). ``bridge`` converts between that layout and the port's.
``from_pretrain`` also loads a reference ``best_model.pth``, whose
parameter names the port's models keep.
"""

from __future__ import annotations

import inspect
import pickle
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from .. import bridge
from ..utils.registry import Registry

MODELS = Registry("model")
register_model = MODELS.register
FRAMEWORK = "sonicsim_tpu"  # the JAX package's pack marker, kept by the port

# model name (lower case) → (state_dict → flax params, flax params → state_dict);
# a function that takes keyword arguments (DPTNet's heads, TDANet's mode) is
# given those of the model's arguments it names.
_FLAX_LAYOUT = {
    "convtasnet": (bridge.convtasnet_flax_params, bridge.convtasnet_state_dict),
    "dprnntasnet": (bridge.dprnn_flax_params, bridge.dprnn_state_dict),
    "sudormrf": (bridge.sudormrf_flax_params, bridge.sudormrf_state_dict),
    "afrcnn": (bridge.afrcnn_flax_params, bridge.afrcnn_state_dict),
    "tdanet": (bridge.tdanet_flax_params, bridge.tdanet_state_dict),
    "dptnetmodel": (bridge.dptnet_flax_params, bridge.dptnet_state_dict),
    "bsrnn": (bridge.bsrnn_flax_params, bridge.bsrnn_state_dict),
    "tfgridnet": (bridge.tfgridnet_flax_params, bridge.tfgridnet_state_dict),
    "mossformer": (bridge.mossformer_flax_params, bridge.mossformer_state_dict),
    "mossformer2": (bridge.mossformer2_flax_params, bridge.mossformer2_state_dict),
    "skimnet": (bridge.skim_flax_params, bridge.skim_state_dict),
    "fullband": (bridge.fullband_flax_params, bridge.fullband_state_dict),
    "fullsubnet": (bridge.fullsubnet_flax_params, bridge.fullsubnet_state_dict),
    "fastfullsubnet": (bridge.fastfullsubnet_flax_params, bridge.fastfullsubnet_state_dict),
    "fullsubnet_plus": (bridge.fullsubnet_plus_flax_params, bridge.fullsubnet_plus_state_dict),
    "inter_subnet": (bridge.inter_subnet_flax_params, bridge.inter_subnet_state_dict),
    "dccrn": (bridge.dccrn_flax_params, bridge.dccrn_state_dict),
    "frcrn": (bridge.frcrn_flax_params, bridge.frcrn_state_dict),
    "bsrnnespnet": (bridge.bsrnn_espnet_flax_params, bridge.bsrnn_espnet_state_dict),
    "gagnet": (bridge.gagnet_flax_params, bridge.gagnet_state_dict),
    "g2net": (bridge.g2net_flax_params, bridge.g2net_state_dict),
    "taylorsenet": (bridge.taylorsenet_flax_params, bridge.taylorsenet_state_dict),
}


def get(identifier: str) -> type:
    return MODELS.get(identifier)


class BaseModel(nn.Module):
    """Common base: a model keeps its constructor's keyword arguments (but
    ``device``) for ``model_args``, and is placed on a device when built."""

    def __init__(self, model_args: dict):
        super().__init__()
        self._model_args = dict(model_args)

    def model_args(self) -> dict:
        return dict(self._model_args)

    def place(self, device) -> None:
        """Move the weights to ``device`` (the card unless given), each RNN's
        weights into the one flat buffer cuDNN reads."""
        self.to(bridge.resolve_device(device))
        for m in self.modules():
            if isinstance(m, nn.RNNBase):
                m.flatten_parameters()


def _layout(name: str):
    try:
        return _FLAX_LAYOUT[name.lower()]
    except KeyError:
        raise NotImplementedError(
            f"no flax layout for {name!r}; the port has {sorted(_FLAX_LAYOUT)}"
        ) from None


def _call(fn, tree: dict, model_args: dict):
    named = list(inspect.signature(fn).parameters)[1:]
    return fn(tree, **{k: v for k, v in model_args.items() if k in named})


def to_flax(name: str, state_dict: dict, model_args: dict) -> dict:
    """Model ``name``'s ``state_dict`` → the JAX package's flax params."""
    return _call(_layout(name)[0], state_dict, model_args)


def to_state_dict(name: str, params: dict, model_args: dict) -> dict:
    """The JAX package's flax params of model ``name`` → the port's
    ``state_dict``."""
    return _call(_layout(name)[1], params, model_args)


def serialize(model: BaseModel) -> dict:
    """The JAX package's portable checkpoint dict for ``model``."""
    from .. import __version__

    name, args = type(model).__name__, model.model_args()
    return {
        "model_name": name,
        "model_args": args,
        "state_dict": to_flax(name, model.state_dict(), args),
        "framework": FRAMEWORK,
        "version": __version__,
    }


def save_model(model: BaseModel, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(serialize(model), f)


# Models whose reference checkpoints were trained under a quirk the port
# replicates only on request (torch_import.py:144-145): TDANet's attention
# over the batch axis, DCCRN's and FRCRN's frozen BatchNorm statistics.
_REFERENCE_ARGS = {name: {"torch_compat": True} for name in ("tdanet", "dccrn", "frcrn")}


def _build(pack: dict, state_dict: dict, device, reference: bool = False) -> BaseModel:
    cls = MODELS.get(pack["model_name"])
    # The reference's get_model_args() adds bookkeeping keys ("n_src",
    # "n_sample_rate") that are no constructor arguments.
    known = set(inspect.signature(cls).parameters) - {"device"}
    args = {k: v for k, v in pack.get("model_args", {}).items() if k in known}
    if reference:
        args.update(_REFERENCE_ARGS.get(pack["model_name"].lower(), {}))
    model = cls(**args, device=device)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    return model.eval()


def from_pretrain(path_or_pack: str | Path | dict, device=None) -> BaseModel:
    """A model with its weights from a checkpoint, on ``device`` (the card
    unless given; ``bridge.resolve_device``). Three kinds load:

    * a pack of either package (``framework: "sonicsim_tpu"``): its flax
      params go through ``bridge``;
    * a reference ``.pth`` (a torch zip, ``PK`` header; base.py:77-81 of the
      JAX package): ``torch.load(weights_only=True)``, and its state dict
      loads as it is; a reference pack already in memory (tensors or numpy
      arrays under the reference's names) likewise. TDANet's is built with
      ``torch_compat=True``, as the JAX package's import does;
    * anything else raises ``ValueError``.
    """
    device = bridge.resolve_device(device)
    if isinstance(path_or_pack, (str, Path)):
        with open(path_or_pack, "rb") as f:
            head = f.read(2)
        if head == b"PK":
            pack = torch.load(path_or_pack, map_location="cpu", weights_only=True)
            return _build(pack, pack["state_dict"], device, reference=True)
        with open(path_or_pack, "rb") as f:
            pack = pickle.load(f)
    else:
        pack = path_or_pack
    if not isinstance(pack, dict) or "model_name" not in pack or "state_dict" not in pack:
        raise ValueError(f"not a model checkpoint: {path_or_pack!r}")
    if pack.get("framework") == FRAMEWORK:
        sd = to_state_dict(pack["model_name"], pack["state_dict"], pack.get("model_args", {}))
        return _build(pack, sd, device)
    if all(torch.is_tensor(v) or isinstance(v, np.ndarray)
           for v in pack["state_dict"].values()):
        return _build(pack, pack["state_dict"], device, reference=True)
    raise ValueError(
        f"checkpoint is neither a pack of framework {FRAMEWORK!r} nor a "
        f"reference state dict: {path_or_pack!r}"
    )
