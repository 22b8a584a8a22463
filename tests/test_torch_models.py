"""ConvTasNet in the port against the JAX package, with the same weights
carried across by ``bridge``: forward at small and full width, bf16, the
reference's parameter names, checkpoints in both directions, and the
entry points' default device.

Tolerances: max abs diff ≤ 1e-5 · max|ref| at small widths and ≤ 1e-4 ·
max|ref| at the full config width (float32 convolutions summed in another
order, through 24 gLN blocks; measured 4e-7 and 1e-6); bf16 within rel-L2
0.05 of float32 (the JAX package's own bound, tests/test_metrics_infer.py).
The weight bridge is exact.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonicsim_tpu.models as JM
from sonicsim_tpu.infer import bf16_forward as j_bf16_forward
from sonicsim_tpu.models.torch_import import import_torch_checkpoint
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.infer import bf16_forward

SMALL = dict(N=32, L=16, B=16, H=32, X=3, R=2)
FULL = dict(N=512, L=32, B=128, H=512, P=3, X=8, R=3, norm="gLN", num_spks=2,
            activate="relu", causal=False, sample_rate=16000)  # convtasnet.yaml
SMALL_REL, FULL_REL, BF16_REL_L2 = 1e-5, 1e-4, 0.05


def _jax_params(cfg, seed=0):
    """JAX init, every leaf moved off its init value (biases, gains and
    slopes too), as numpy: a wrong mapping of any parameter shows."""
    rng = np.random.default_rng(seed)
    p = JM.ConvTasNet(**cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 800)))
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), p)


def _port(cfg, params):
    model = TM.ConvTasNet(**cfg, device="cpu")
    model.load_state_dict(bridge.convtasnet_state_dict(params))
    return model.eval()


def _run(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


def _close(ours, ref, rel):
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * np.abs(ref).max())


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("norm", ["gLN", "cLN"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("activate", ["relu", "sigmoid", "softmax"])
def test_small_width_forward(norm, causal, activate):
    cfg = dict(SMALL, norm=norm, causal=causal, activate=activate)
    params = _jax_params(cfg)
    x = np.random.default_rng(1).standard_normal((2, 1000)).astype(np.float32)
    ref = np.asarray(JM.ConvTasNet(**cfg).apply(params, x))
    _close(_run(_port(cfg, params), x), ref, SMALL_REL)


def test_full_width_forward_and_parameter_count():
    params = _jax_params(FULL)
    model = _port(FULL, params)
    assert (sum(p.numel() for p in model.parameters())
            == sum(a.size for a in jax.tree.leaves(params)) == 3_491_505)
    x = np.random.default_rng(2).standard_normal((1, 4000)).astype(np.float32)
    ref = np.asarray(jax.jit(JM.ConvTasNet(**FULL).apply)(params, x))
    _close(_run(model, x), ref, FULL_REL)


@pytest.mark.parametrize("norm", ["gLN", "cLN"])
def test_bf16_forward(norm):
    cfg = dict(SMALL, norm=norm)
    params = _jax_params(cfg)
    model = _port(cfg, params)
    x = np.random.default_rng(3).standard_normal((2, 1600)).astype(np.float32)
    jm = JM.ConvTasNet(**cfg)
    ref32 = np.asarray(jm.apply(params, x))
    ref16 = np.asarray(jax.jit(j_bf16_forward(jm))(params, x))
    ours32 = _run(model, x)
    with torch.inference_mode():
        ours16 = bf16_forward(model)(torch.from_numpy(x))
    assert ours16.dtype == torch.float32
    ours16 = ours16.numpy()
    assert _rel_l2(ref16, ref32) < BF16_REL_L2
    assert _rel_l2(ours16, ours32) < BF16_REL_L2
    assert _rel_l2(ours16, ref16) < BF16_REL_L2
    assert 0 < _rel_l2(ours16, ours32)  # really computed in bfloat16
    assert next(model.parameters()).dtype == torch.float32  # the model is untouched


@pytest.mark.parametrize("norm", ["gLN", "cLN"])
def test_bridge_round_trip_is_exact(norm):
    params = _jax_params(dict(SMALL, norm=norm))
    back = bridge.convtasnet_flax_params(bridge.convtasnet_state_dict(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_port_keeps_the_reference_parameter_names():
    """The JAX package's importer of reference checkpoints reads the port's
    state dict as a reference one, and its model then computes the port's
    outputs."""
    cfg = dict(SMALL, num_spks=3)
    model = _port(cfg, _jax_params(cfg, seed=4))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jm, params = import_torch_checkpoint(
        {"model_name": "ConvTasNet", "model_args": model.model_args(), "state_dict": sd})
    x = np.random.default_rng(5).standard_normal((2, 900)).astype(np.float32)
    _close(_run(model, x), np.asarray(jm.apply(params, x)), SMALL_REL)


def _only_plain_data(node):
    if isinstance(node, dict):
        return all(isinstance(k, str) and _only_plain_data(v) for k, v in node.items())
    return isinstance(node, (np.ndarray, str, int, float, bool))


def test_checkpoints_load_in_both_directions(tmp_path):
    cfg = dict(SMALL, norm="cLN", activate="sigmoid")
    params = _jax_params(cfg, seed=6)
    jm = JM.ConvTasNet(**cfg)
    x = np.random.default_rng(7).standard_normal((2, 1200)).astype(np.float32)
    ref = np.asarray(jm.apply(params, x))

    JM.save_model(jm, params, tmp_path / "jax.pkl")  # JAX pack → the port
    _close(_run(TM.from_pretrain(tmp_path / "jax.pkl", device="cpu"), x), ref, SMALL_REL)

    TM.save_model(_port(cfg, params), tmp_path / "port.pkl")  # port pack → JAX
    with open(tmp_path / "port.pkl", "rb") as f:
        pack = pickle.load(f)
    assert pack["framework"] == "sonicsim_tpu" and _only_plain_data(pack)
    jm2, params2 = JM.from_pretrain(tmp_path / "port.pkl")
    assert jm2 == jm
    for a, b in zip(jax.tree.leaves(params2), jax.tree.leaves(params)):
        assert np.array_equal(np.asarray(a), b)


def test_reference_pth_loads_as_it_is(tmp_path):
    """A reference ``best_model.pth`` (torch zip; the reference's
    bookkeeping keys among its model_args) loads through
    ``weights_only=True``; anything that is no checkpoint raises."""
    cfg = dict(SMALL, causal=True)
    model = _port(cfg, _jax_params(cfg, seed=8))
    args = dict(model.model_args(), n_src=2, n_sample_rate=16000)
    torch.save({"model_name": "ConvTasNet", "model_args": args,
                "state_dict": model.state_dict()}, tmp_path / "best_model.pth")
    loaded = TM.from_pretrain(tmp_path / "best_model.pth", device="cpu")
    x = np.random.default_rng(9).standard_normal((1, 700)).astype(np.float32)
    np.testing.assert_array_equal(_run(loaded, x), _run(model, x))
    with open(tmp_path / "other.pkl", "wb") as f:
        pickle.dump({"weights": [1, 2]}, f)
    with pytest.raises(ValueError):
        TM.from_pretrain(tmp_path / "other.pkl", device="cpu")


def test_api_shapes_and_errors():
    model = _port(SMALL, _jax_params(SMALL))
    x = np.random.default_rng(10).standard_normal(500).astype(np.float32)
    one = _run(model, x)
    assert one.shape == (1, 2, 500)  # 1-D input → B = 1, not squeezed
    np.testing.assert_array_equal(one, _run(model, x[None]))
    with pytest.raises(ValueError, match="N == H"):
        TM.ConvTasNet(N=32, H=16, device="cpu")
    assert TM.get("convtasnet") is TM.get("ConvTasNet") is TM.ConvTasNet


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.ConvTasNet(**SMALL)
    model = TM.ConvTasNet(**SMALL, device="cpu")
    TM.save_model(model, tmp_path / "m.pkl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.from_pretrain(tmp_path / "m.pkl")
