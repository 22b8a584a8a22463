"""The port's bf16 LSTM and GRU layers against flax's, on the CPU.

flax's cells compute the input dense of a bfloat16 input on bfloat16
weights in bfloat16: the LSTM rounds ``W_ih·x`` (its input denses have no
bias), the GRU ``W_ih·x + b_ih``. The carry is float32, so the gates, the
recurrence and the output are float32 after that rounding. Each layer of
flax's stack (the JAX ``SequenceModel``) is its own ``nn.RNN``, so only the
first one reads a bfloat16 input; the later ones read float32.

The port's ``LSTMLayer`` and ``GRULayer`` (``zoo_layers.recurrent_layer``)
take the same seeded weights through the bridge and run as
``infer.precision`` runs a model in bf16: the state cast to bfloat16 and
the module called on a bfloat16 input. Both directions and one and two
layers, within 1e-5 rel-L2 of flax's output (float32 parity: the gap before
the port rounded the projection was about 1e-3). A float32 input on
bfloat16 weights is rounded nowhere, in flax as in the port: its output is
the float32 layer's on the weights rounded to bfloat16, bit for bit, and
flax's within the same 1e-5.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicsim_tpu.infer.precision import cast_floating
from sonicsim_tpu.models.fullsubnet import SequenceModel
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch.models.zoo_layers import recurrent_layer

from torch_threads import one_intra_op_thread  # noqa: F401

B, T, C, H = 2, 60, 24, 32
REL = 1e-5
CASES = [(kind, bi, layers) for kind in ("LSTM", "GRU") for bi in (False, True)
         for layers in (1, 2)]


def _ids(cases):
    return [f"{k}-{'bi' if b else 'uni'}-{n}layer" for k, b, n in cases]


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def pair(kind, bi, layers, seed=0):
    """The flax stack with seeded weights, its jitted ``apply`` and the port's
    layer holding them, made once per shape."""
    jm = SequenceModel(output_size=0, hidden_size=H, num_layers=layers, bidirectional=bi,
                       sequence_model=kind, output_activate_function=False)
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((1, 4, C)))
    layer = recurrent_layer(kind, C, H, bi, layers)
    sd = bridge._stack_to_torch(jax.tree.map(np.asarray, params["params"]), "rnn", bi)
    layer.load_state_dict({k[len("rnn."):]: torch.from_numpy(v.copy()) for k, v in sd.items()})
    return jax.jit(jm.apply), params, layer.eval()


def inputs(seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, C)).astype(np.float32)


def port_call(layer, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """``layer`` on its state cast to ``dtype``, as ``infer.precision`` calls a
    model in bf16."""
    state = {n: p.to(dtype) for n, p in layer.named_parameters()}
    with torch.no_grad():
        return torch.func.functional_call(layer, state, (x,))


@pytest.mark.parametrize("kind,bi,layers", CASES, ids=_ids(CASES))
def test_bf16_layer_is_flax_bf16(kind, bi, layers):
    apply, params, layer = pair(kind, bi, layers)
    x = inputs()
    want = apply(cast_floating(params), jnp.asarray(x, jnp.bfloat16))
    got = port_call(layer, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.shape == want.shape == (B, T, H * (2 if bi else 1))
    with torch.no_grad():  # float32: the rounding is really there
        assert rel_l2(got.numpy(), layer(torch.from_numpy(x)).numpy()) > 100 * REL
    assert rel_l2(got.numpy(), want) < REL, rel_l2(got.numpy(), want)


@pytest.mark.parametrize("kind,bi", [("LSTM", True), ("GRU", False)])
def test_float32_input_on_bf16_weights_rounds_nothing(kind, bi):
    apply, params, layer = pair(kind, bi, 2)
    x = inputs()
    got = port_call(layer, torch.from_numpy(x))
    rounded = {n: p.to(torch.bfloat16).to(torch.float32) for n, p in layer.named_parameters()}
    with torch.no_grad():
        plain = torch.func.functional_call(layer, rounded, (torch.from_numpy(x),))
    assert torch.equal(got, plain)
    want = apply(cast_floating(params), jnp.asarray(x))
    assert rel_l2(got.numpy(), want) < REL, rel_l2(got.numpy(), want)


def test_gradients_reach_the_input_weights():
    """The identity that carries the rounded projection is a constant: the
    gradient of a bf16 step reaches ``weight_ih`` and, for the GRU,
    ``bias_ih`` through the projection, and the layer's parameters stay
    float32."""
    for kind in ("LSTM", "GRU"):
        layer = copy.deepcopy(pair(kind, True, 1)[2]).train()
        state = {n: p.to(torch.bfloat16) for n, p in layer.named_parameters()}
        x = torch.from_numpy(inputs()).to(torch.bfloat16)
        torch.func.functional_call(layer, state, (x,)).square().mean().backward()
        for name, p in layer.named_parameters():
            assert p.dtype == torch.float32
            if name.startswith(("weight_ih", "bias_ih")):
                assert p.grad is not None and bool(p.grad.abs().sum() > 0), (kind, name)
