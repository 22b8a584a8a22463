"""The enhancement zoo's weight bridge against the JAX package: the port's
``<name>_flax_params`` on a seeded reference-named state dict equals the JAX
package's converter (``import_torch_checkpoint``) leaf for leaf, exactly;
flax → torch → flax is exact and torch → flax → torch the same function
(within 1e-6 · max|out|); packs cross between the packages with equal
weights; reference checkpoints of DCCRN and FRCRN load as they are, with
their frozen BatchNorm statistics, as the JAX package imports them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonicsim_tpu.models as JM
from sonicsim_tpu.models.torch_import import import_torch_checkpoint
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.models import base as TB

from test_torch_enh_models import SMALL, jax_params, port
from torch_threads import one_intra_op_thread  # noqa: F401

# The JAX converters of DCCRN and FRCRN take the reference checkpoints'
# frozen statistics only (``torch_compat=True``); the port's pair maps both.
COMPAT = ("DCCRN", "FRCRN")
CONVERTER_CASES = [(n, dict(c, torch_compat=True) if n in COMPAT else c) for n, c in SMALL.items()]
CONVERTER_CASES.append(("BSRNNESPNet", dict(SMALL["BSRNNESPNet"], causal=True)))
ROUND_TRIP_CASES = list(SMALL.items()) + [("DCCRN", dict(SMALL["DCCRN"], torch_compat=True))]


def _leaves_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


def _reference_state_dict(name, cfg, seed=0):
    """A state dict under the reference's names with every entry drawn from
    a seed (LSTM ``bias_hh`` and running variances too, the variances kept
    positive), as numpy."""
    g = torch.Generator().manual_seed(seed)
    model = TM.get(name)(**cfg, device="cpu")
    out = {}
    for k, v in model.state_dict().items():
        v = v + 0.1 * torch.randn(v.shape, generator=g)
        out[k] = (v.abs() + 0.5 if k.endswith("running_var") else v).numpy()
    return out


def _out(model, x):
    """The waveform, the refined FRCRN stage's or the cIRM."""
    out = model(x)
    if not isinstance(out, tuple):
        return out
    return out[1][4] if isinstance(out[1], list) else out[0]


@pytest.mark.parametrize("name,cfg", CONVERTER_CASES, ids=lambda v: v if isinstance(v, str) else "")
def test_flax_params_equal_the_jax_converter(name, cfg):
    sd = _reference_state_dict(name, cfg)
    ours = TB.to_flax(name, sd, dict(cfg))
    _, ref = import_torch_checkpoint({"model_name": name, "model_args": {}, "state_dict": sd},
                                     model=JM.get(name)(**cfg))
    _leaves_equal(ours, jax.tree.map(np.asarray, ref))


@pytest.mark.parametrize("name,cfg", ROUND_TRIP_CASES, ids=lambda v: v if isinstance(v, str) else "")
def test_round_trips(name, cfg):
    """flax → torch → flax exactly; torch → flax → torch computes the same
    function (an LSTM's two biases come back summed in ``bias_ih``)."""
    params = jax_params(name, cfg)
    model = port(name, cfg, params)
    _leaves_equal(TB.to_flax(name, model.state_dict(), model.model_args()), params)

    sd = _reference_state_dict(name, cfg)
    other = TM.get(name)(**cfg, device="cpu").eval()
    other.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    back = port(name, cfg, TB.to_flax(name, sd, other.model_args()))
    x = torch.from_numpy((0.3 * np.random.default_rng(3).standard_normal((1, 3200)))
                         .astype(np.float32))
    with torch.inference_mode():
        want, got = _out(other, x), _out(back, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["Fullband", "DCCRN", "BSRNNESPNet"])
def test_packs_cross_both_ways(name, tmp_path):
    """The port's ``save_model`` pack loads in the JAX package's
    ``from_pretrain`` with the same weights, and the JAX package's pack in
    the port's."""
    cfg = SMALL[name]
    params = jax_params(name, cfg)
    TM.save_model(port(name, cfg, params), tmp_path / "port.pkl")
    jm, jp = JM.from_pretrain(tmp_path / "port.pkl")
    assert type(jm).__name__ == name
    _leaves_equal(jax.tree.map(np.asarray, jp), params)
    JM.save_model(JM.get(name)(**cfg), jax.tree.map(jnp.asarray, params), tmp_path / "jax.pkl")
    ours = TM.from_pretrain(tmp_path / "jax.pkl", device="cpu")
    assert type(ours).__name__ == name
    _leaves_equal(TB.to_flax(name, ours.state_dict(), ours.model_args()), params)


@pytest.mark.parametrize("name", COMPAT)
def test_reference_checkpoints_load_with_frozen_statistics(name, tmp_path):
    cfg = SMALL[name]
    sd = {k: torch.from_numpy(v)
          for k, v in _reference_state_dict(name, dict(cfg, torch_compat=True)).items()}
    path = tmp_path / f"{name}.pth"
    torch.save({"model_name": name, "model_args": dict(cfg, n_src=1), "state_dict": sd}, path)
    model = TM.from_pretrain(path, device="cpu")
    assert model.model_args()["torch_compat"] is True
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
