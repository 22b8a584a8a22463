"""Reduced-precision serving and training, as the JAX package computes them.

Port of ``sonicsim_tpu.infer.precision``. The JAX ``bf16_forward`` casts the
variable tree and the input to bfloat16 and leaves the rest to JAX's type
promotion, so a JAX model computes in bfloat16 only until something
float32 meets it, and in float32 on bfloat16-rounded weights after that:

* after each LSTM (flax's cell makes its zero carry in float32);
* after each STFT (frames times a float32 window; ``jnp.fft`` takes no
  bfloat16);
* where a float32 constant table (a window, a pseudo-inverse, a mel bank,
  positional and rotary tables) meets an activation.

flax's built-in norms take their statistics in float32 and return the
promoted dtype. The port computes the same schedule: :func:`cast_state`
casts exactly the state the bridge maps into the JAX variable tree (every
parameter, and the frozen BatchNorm statistics, ``running_mean`` and
``running_var``) and nothing else, and the model runs on it through
``torch.func.functional_call``; its layers follow the promotion rule
(``models.layers``), its LSTMs flax's carry (``models.zoo_layers``), and its
constant tables are float32 or the input's dtype where that is wider. The
stored model stays float32. ``torch.autocast`` is not that function: it
picks the dtype per operator, not by promotion. ``bf16_forward`` and
``train.make_train_step(precision="bf16")`` share :func:`cast_state`.

Which models take bf16: each whose JAX bf16 path runs and whose bf16
output lies within rel-L2 0.05 of float32 on both sides
(``BF16_MODELS``); :func:`require_bf16` refuses the others by name, with
the reason (``BF16_REFUSED``), and bf16 training where the JAX package's
bf16 step raises (``BF16_TRAIN_REFUSED``). A variant no config takes (a
GRU FullSubNet, DCCRN without its complex LSTM, GaGNet without its U²
encoder) is decided by its own name (:func:`variant_name`), never as its
config's model.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

BF16_MODELS = (
    "ConvTasNet", "DPRNNTasNet", "DPTNetModel", "SuDORMRF", "AFRCNN", "BSRNN", "TFGridNet",
    "MossFormer", "SkiMNet", "Fullband", "FullSubnet", "FastFullSubnet", "FullSubNet_Plus",
    "Inter_SubNet", "DCCRN", "BSRNNESPNet", "TaylorSENet",
    # Variants no config takes (variant_name), each within the gate three
    # ways at the tests' widths (tests/test_torch_variants.py).
    "Fullband(sequence_model='GRU')", "FullSubnet(sequence_model='GRU')",
    "FastFullSubnet(sequence_model='GRU')", "FullSubNet_Plus(sequence_model='GRU')",
    "DCCRN(use_clstm=False)",
)
_CONV_DTYPES = ("the JAX package's bf16 raises at sonicsim_tpu/models/layers.py:156 "
                "(lax.conv_general_dilated on a float32 input and bfloat16 weights)")
BF16_REFUSED = {
    "TDANet": _CONV_DTYPES,
    "MossFormer2": _CONV_DTYPES,
    "FRCRN": ("its bf16 waveform lies 6.9e-2 (rel-L2) from float32 in the JAX package and "
              "in the port alike, over the zoo's 0.05 gate (seeded weights, "
              "tests/test_torch_bf16_enh.py)"),
    "GaGNet": ("at its config's width its bf16 waveform lies 0.45 (rel-L2) from float32 on a "
               "tone in noise in the JAX package and in the port alike, and 0.30 on a "
               "generated mixture on the card, over the zoo's 0.05 gate (seeded weights, "
               "tests/test_torch_bf16_enh.py, chip_smoke.py phase 13)"),
    "GaGNet(is_u2=False)": (
        "at its config's other widths its bf16 waveform lies 0.29 (rel-L2) from float32 on a "
        "tone in noise in the JAX package and in the port alike, over the zoo's 0.05 gate "
        "(seeded weights, tests/test_torch_variants.py)"),
    "G2Net": ("at its config's width its bf16 waveform lies 0.49 (rel-L2) from float32 on a "
              "tone in noise in the JAX package and in the port alike, over the zoo's 0.05 "
              "gate (seeded weights, tests/test_torch_bf16_enh.py)"),
}
_MIXED_SHAPES = ("the JAX package's bf16 train step raises at sonicsim_tpu/train/trainer.py:123 "
                 "(jnp.asarray(ests, jnp.float32) on outputs of mixed shapes)")
BF16_TRAIN_REFUSED = {name: _MIXED_SHAPES for name in (
    "Fullband", "FullSubnet", "FastFullSubnet", "FullSubNet_Plus", "Inter_SubNet", "FRCRN")}
# The state the bridge maps besides the parameters: frozen BatchNorm statistics.
_MAPPED_BUFFERS = ("running_mean", "running_var")


# The arguments whose other values make a variant no config takes, each
# held on its own (tests/test_torch_variants.py), by the configs' value.
# Inter-SubNet's ``sequence_model`` is no such argument: the JAX model never
# reads it.
_CONFIG_VALUES = {"sequence_model": "LSTM", "use_clstm": True, "is_u2": True}
_IGNORED = {"Inter_SubNet": ("sequence_model",)}


def variant_name(model: nn.Module) -> str:
    """The model's class name, and in parentheses each argument that makes
    it a variant no config takes (``"DCCRN(use_clstm=False)"``): what
    :func:`require_bf16` decides by."""
    name = type(model).__name__
    args = model.model_args() if hasattr(model, "model_args") else {}
    flips = [f"{k}={args[k]!r}" for k, v in _CONFIG_VALUES.items()
             if k in args and args[k] != v and k not in _IGNORED.get(name, ())]
    return f"{name}({', '.join(flips)})" if flips else name


def require_bf16(model: nn.Module, train: bool = False) -> None:
    """Raise ``NotImplementedError`` unless ``model`` may run (with ``train``,
    train) in bf16, naming the model, its variant and the reason. bf16
    training is refused for a model's every variant where it is refused for
    the model."""
    name = variant_name(model)
    reasons = []
    if name in BF16_REFUSED:
        reasons.append(f"bf16 is refused: {BF16_REFUSED[name]}")
    elif name not in BF16_MODELS:
        reasons.append(f"bf16 is held against float32 for {BF16_MODELS} only")
    base = type(model).__name__
    if train and base in BF16_TRAIN_REFUSED:
        reasons.append(f"bf16 training is refused: {BF16_TRAIN_REFUSED[base]}")
    if reasons:
        raise NotImplementedError(f"{name}: {'; '.join(reasons)}; run it in float32")


def cast_state(model: nn.Module, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The state the bridge maps into the JAX variable tree, its floating
    tensors cast to ``dtype`` (a differentiable ``.to``: gradients reach the
    float32 parameters through it), for ``torch.func.functional_call``."""
    state = dict(model.named_parameters())
    state.update((n, b) for n, b in model.named_buffers()
                 if n.rsplit(".", 1)[-1] in _MAPPED_BUFFERS)
    return {n: t.to(dtype) if t.is_floating_point() else t for n, t in state.items()}


def to_float32(out):
    """``out``'s floating tensors (in tuples and lists) as float32."""
    if isinstance(out, (tuple, list)):
        return type(out)(to_float32(o) for o in out)
    return out.to(torch.float32) if torch.is_tensor(out) and out.is_floating_point() else out


def bf16_call(model: nn.Module, state: dict, x: torch.Tensor):
    """``model`` on ``state`` (:func:`cast_state`) and ``x`` cast to
    bfloat16, its outputs in the dtypes the promotion leaves them in."""
    return torch.func.functional_call(model, state, (x.to(torch.bfloat16),))


def bf16_forward(model: nn.Module) -> Callable:
    """``fwd(x) -> float32 output`` computing as the JAX ``bf16_forward``.

    The state is cast here, once, so the float32 model is left as it is;
    weights changed on ``model`` after this call are not seen by ``fwd``.
    """
    require_bf16(model)
    state = {n: t.detach() for n, t in cast_state(model).items()}

    def fwd(x: torch.Tensor):
        return to_float32(bf16_call(model, state, x))

    return fwd
