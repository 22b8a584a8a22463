"""The zoo's weight bridge against the JAX package: the port's
``<name>_flax_params`` on a seeded reference-named state dict equals the JAX
package's ``import_torch_checkpoint`` leaf for leaf, exactly; flax → torch →
flax is exact and torch → flax → torch the same function; packs cross
between the packages, with equal weights and (for three models) equal
outputs within 1e-5 · max|ref|; reference checkpoints load as they are.
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

from test_torch_zoo_models import CASES, SMALL, jax_params, port

REL = 1e-5


def _leaves_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


def _reference_state_dict(name, cfg, seed=0):
    """A state dict under the reference's names with every entry drawn from
    a seed (LSTM ``bias_hh`` too), as numpy."""
    g = torch.Generator().manual_seed(seed)
    model = TM.get(name)(**cfg, device="cpu")
    return {k: (v + 0.1 * torch.randn(v.shape, generator=g)).numpy()
            for k, v in model.state_dict().items()}


# The JAX converter maps DPRNN's LSTMs as unidirectional only
# (torch_import.py:183, ``lstm_cell``), so its bidirectional DPRNN tree lacks
# the backward cells its own model has; that case is held by the round trips.
CONVERTER_CASES = [(n, c) for n, c in CASES if not (n == "DPRNNTasNet" and c.get("bidirectional"))]


@pytest.mark.parametrize("name,cfg", CONVERTER_CASES,
                         ids=lambda v: v if isinstance(v, str) else "")
def test_flax_params_equal_the_jax_converter(name, cfg):
    cfg = dict(cfg, torch_compat=True) if name == "TDANet" else cfg  # the converter's only mode
    sd = _reference_state_dict(name, cfg)
    ours = TB.to_flax(name, sd, dict(cfg))
    _, ref = import_torch_checkpoint({"model_name": name, "model_args": {}, "state_dict": sd},
                                     model=JM.get(name)(**cfg))
    _leaves_equal(ours, jax.tree.map(np.asarray, ref))


@pytest.mark.parametrize("name,cfg", CASES, ids=lambda v: v if isinstance(v, str) else "")
def test_round_trips(name, cfg):
    """flax → torch → flax exactly; torch → flax → torch computes the same
    function (an LSTM's two biases come back summed in ``bias_ih``)."""
    params = jax_params(name, cfg)
    model = port(name, cfg, params)
    _leaves_equal(TB.to_flax(name, model.state_dict(), model.model_args()), params)

    sd = _reference_state_dict(name, cfg)
    other = TM.get(name)(**cfg, device="cpu").eval()
    other.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    back = TM.get(name)(**cfg, device="cpu").eval()
    back.load_state_dict(TB.to_state_dict(name, TB.to_flax(name, sd, other.model_args()),
                                          back.model_args()))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 1601)).astype(np.float32))
    with torch.inference_mode():
        want, got = other(x), back(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


FORWARD = ("DPRNNTasNet", "TDANet", "MossFormer2")


@pytest.mark.parametrize("name", list(SMALL))
def test_packs_cross_both_ways(name, tmp_path):
    """The port's ``save_model`` pack loads in the JAX package's
    ``from_pretrain`` with the same weights, and the JAX package's pack in
    the port's; for three models the outputs of both are compared too."""
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
    if name in FORWARD:
        x = np.random.default_rng(4).standard_normal((1, 1601)).astype(np.float32)
        ref = np.asarray(jax.jit(jm.apply)(jp, x))
        with torch.inference_mode():
            got = ours(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=REL * np.abs(ref).max())


def test_reference_checkpoints_load_as_they_are(tmp_path):
    """A reference ``best_model.pth`` (a torch zip of the reference's names,
    constant buffers included) loads through ``from_pretrain``: TDANet in
    the reference's batch-axis mode, as the JAX package imports it, and
    MossFormer with its ``inv_freq`` and TDANet with its ``pe`` tables
    skipped."""
    for name, extra in (("TDANet", {"sm.unet.globalatt.attn.pe": torch.zeros(1, 100, 32)}),
                        ("MossFormer", {"mask_net.pos_enc.inv_freq": torch.zeros(16)})):
        sd = {k: torch.from_numpy(v) for k, v in _reference_state_dict(name, SMALL[name]).items()}
        path = tmp_path / f"{name}.pth"
        torch.save({"model_name": name, "model_args": dict(SMALL[name], n_src=2),
                    "state_dict": {**sd, **extra}}, path)
        model = TM.from_pretrain(path, device="cpu")
        assert model.model_args().get("torch_compat", True) is True
        for k, v in model.state_dict().items():
            assert torch.equal(v, sd[k]), k
