"""The model variants no config takes, in the port against the JAX package:
Inter-SubNet with ``sequence_model="GRU"`` (which the JAX model ignores),
the FullSubNet family with ``sequence_model="GRU"``, DCCRN with
``use_clstm=False`` and GaGNet with ``is_u2=False``; the stacked
bidirectional ``SequenceModel`` and one GRU layer against flax's
``GRUCell``.

Each variant at the tests' small widths, with seeded weights carried by the
bridge: its forward (the tolerance of the config's own model in
tests/test_torch_enh_models.py and tests/test_torch_gagnet.py), its bridge
(exact round trips, packs both ways), its float32 train step against optax
(tests/test_torch_enh_train.py's bounds) and its bf16 verdict against the
JAX package's readings.

Where a variant is ill-conditioned in float32, the JAX package in float64
(``jax_float64``) referees it: the port's float64 within ``F64_REL`` of it,
the port's float32 within ``ILL_FACTOR`` times JAX's own float32 distance
from it (chip_smoke.py's rule for the card against the CPU).
"""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sonicsim_tpu.infer as JI
import sonicsim_tpu.losses as JL
import sonicsim_tpu.models as JM
from sonicsim_tpu.infer.precision import bf16_forward as j_bf16_forward
from sonicsim_tpu.models import fullsubnet as JS
from sonicsim_tpu.train import make_optimizer as j_make_optimizer
from sonicsim_tpu.train import make_train_step as j_make_train_step
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch import losses as TL
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.infer import to_waveform
from sonicsim_tpu_torch.infer.precision import (BF16_MODELS, BF16_REFUSED, bf16_call,
                                                bf16_forward, cast_state, require_bf16,
                                                to_float32, variant_name)
from sonicsim_tpu_torch.models import base as TB
from sonicsim_tpu_torch.models import fullsubnet as TS
from sonicsim_tpu_torch.models.zoo_layers import GRULayer
from sonicsim_tpu_torch.train import make_optimizer, make_train_step

from test_torch_bf16_sep import Readings, check_forward, check_refused, rel_l2
from test_torch_enh_models import SMALL as ENH_SMALL
from test_torch_enh_models import T as ENH_T
from test_torch_enh_models import _leaves, jax_params, port
from test_torch_enh_train import (CLIP, GRAD_REL, LOSS_REL, LR, NOISE_SHARE, PARAM_ATOL,
                                  _batch)
from test_torch_gagnet import SMALL as GAG_SMALL
from test_torch_train_step import adam_mu
from torch_threads import one_intra_op_thread  # noqa: F401

GRU = dict(sequence_model="GRU")
VARIANTS = {  # id: (model, arguments, forward tolerance of max|ref|)
    "inter_subnet-gru": ("Inter_SubNet", dict(ENH_SMALL["Inter_SubNet"], **GRU), 3e-5),
    "fullband-gru": ("Fullband", dict(ENH_SMALL["Fullband"], **GRU), 1e-5),
    "fullsubnet-gru": ("FullSubnet", dict(ENH_SMALL["FullSubnet"], **GRU), 1e-5),
    "fastfullsubnet-gru": ("FastFullSubnet", dict(ENH_SMALL["FastFullSubnet"], **GRU), 1e-5),
    "fullsubnet_plus-gru": ("FullSubNet_Plus", dict(ENH_SMALL["FullSubNet_Plus"], **GRU), 1e-4),
    "dccrn-lstm": ("DCCRN", dict(ENH_SMALL["DCCRN"], use_clstm=False), 1e-5),
    # 129 bins → 63, 31, 15, 7, 3 through the five stride-2 gates: 64 · 3 = 192.
    "gagnet-unet": ("GaGNet", dict(GAG_SMALL["GaGNet"], is_u2=False), 1e-5),
}
IDS = list(VARIANTS)
_STFT = (256, 128, 256)
LOSSES = {  # the variant's config loss on the small models' STFT: JAX's, the port's
    "DCCRN": (JL.DCCRNLoss, TL.DCCRNLoss, ()),
    "GaGNet": (JL.GaGNetLoss, TL.GaGNetLoss, _STFT),
    "FastFullSubnet": (JL.FullbandLoss, TL.FullbandLoss, (512, 256, 512)),  # its own FFT
}


def _losses(name):
    j, t, args = LOSSES.get(name, (JL.FullbandLoss, TL.FullbandLoss, _STFT))
    return j(*args), t(*args)


def _equal(a, b):
    fa, fb = (sorted((jax.tree_util.keystr(p), np.asarray(v))
                     for p, v in jax.tree_util.tree_flatten_with_path(t)[0]) for t in (a, b))
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, va), (_, vb) in zip(fa, fb):
        assert va.shape == vb.shape and np.array_equal(va, vb), k


def test_inter_subnet_takes_and_ignores_sequence_model():
    """The JAX model declares ``sequence_model`` and never reads it; the port
    builds it, keeps it in ``model_args`` and runs the same LSTMs."""
    name, cfg, _ = VARIANTS["inter_subnet-gru"]
    model = TM.get(name)(**cfg, device="cpu")
    assert model.model_args()["sequence_model"] == "GRU"
    lstm = TM.get(name)(**ENH_SMALL[name], device="cpu")
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in lstm.state_dict().items()}
    assert variant_name(model) == name  # the same model: its bf16 verdict is the config's


# On tests/test_torch_enh_models.py's batch the GRU FullSubNet+'s float32
# forward lies 1.68e-4 · max|ref| from JAX's, over the config's 1e-4, and
# JAX's own float32 1.19e-4 from JAX in float64 (the config's eight TCN
# blocks with GroupNorm epsilon 1e-8): JAX in float64 referees it there.
FWD_F64 = ("fullsubnet_plus-gru",)


@contextlib.contextmanager
def jax_float64():
    """The JAX package in float64: x64 on, and flax's RNN cells' carries in
    float64 (flax makes them in the cell's ``param_dtype``, float32, which
    its ``lax.scan`` refuses beside a float64 step)."""
    cells = (fnn.GRUCell, fnn.OptimizedLSTMCell, fnn.LSTMCell)
    saved = [cell.initialize_carry for cell in cells]

    def wide(init):
        return fnn.nowrap(lambda self, rng, shape: jax.tree.map(
            lambda c: c.astype(jnp.float64), init(self, rng, shape)))

    try:
        for cell, init in zip(cells, saved):
            cell.initialize_carry = wide(init)
        with jax.enable_x64(True):
            yield
    finally:
        for cell, init in zip(cells, saved):
            cell.initialize_carry = init


def _to_f64(tree):
    return jax.tree.map(lambda v: jnp.asarray(np.asarray(v, np.float64)), tree)


def _dist(a, b) -> float:
    """The largest distance between two lists of arrays, leaf for leaf."""
    assert len(a) == len(b) and all(np.shape(u) == np.shape(v) for u, v in zip(a, b))
    return max(float(np.abs(np.asarray(u, np.float64) - np.asarray(v, np.float64)).max())
               for u, v in zip(a, b))


def _params(tree) -> list:
    """A flax tree's ``params`` leaves, in path order."""
    return jax.tree.leaves(tree.get("params", tree))


@pytest.mark.parametrize("case", IDS)
def test_forward_matches_jax(case):
    """Every output of the forward on a seeded (2, T) batch (the bf16
    readings' float32 side, one JAX compile for both tests); a variant of
    ``FWD_F64`` on tests/test_torch_enh_models.py's batch against JAX in
    float64."""
    name, cfg, tol = VARIANTS[case]
    if case in FWD_F64:
        _forward_to_jax_float64(name, cfg, tol)
        return
    r = readings(case)
    ref, ours = _leaves(r.j32), _leaves(r.t32)
    assert len(ours) == len(ref)
    for got, want in zip(ours, ref):
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _forward_to_jax_float64(name, cfg, tol):
    """The port's float64 forward within ``F64_REL`` · max|ref64| of JAX's
    in float64, and its float32 within max(``tol``, ``ILL_FACTOR`` x JAX's
    float32 distance from float64) · max|ref64|."""
    params = jax_params(name, cfg)
    x = (0.3 * np.random.default_rng(1).standard_normal((2, ENH_T))).astype(np.float32)
    jm = JM.get(name)(**cfg)
    j32 = _leaves(jax.jit(jm.apply)(params, x))
    with jax_float64():
        j64 = _leaves(jax.jit(jm.apply)(_to_f64(params), jnp.asarray(x, jnp.float64)))
    model = port(name, cfg, params)
    with torch.inference_mode():
        t32 = _leaves(model(torch.from_numpy(x)))
        t64 = _leaves(model.double()(torch.from_numpy(x).double()))
    assert len(t32) == len(t64) == len(j32) == len(j64)
    for got, got64, jax32, ref in zip(t32, t64, j32, j64):
        assert got.shape == got64.shape == jax32.shape == ref.shape and np.isfinite(got).all()
        assert ref.dtype == np.float64 and got64.dtype == np.float64
        top = np.abs(ref).max()
        np.testing.assert_allclose(got64, ref, rtol=0, atol=chip_smoke.F64_REL * top)
        bound = max(tol, chip_smoke.ILL_FACTOR * _dist([jax32], [ref]) / top)
        np.testing.assert_allclose(got, ref, rtol=0, atol=bound * top)


@pytest.mark.parametrize("case", IDS)
def test_bridge_round_trips_and_packs(case, tmp_path):
    """flax → port → flax exactly; port → flax → port the same tensors; the
    port's pack in the JAX package's ``from_pretrain`` and the JAX package's
    pack in the port's."""
    name, cfg, _ = VARIANTS[case]
    params = jax_params(name, cfg)
    model = port(name, cfg, params)
    _equal(TB.to_flax(name, model.state_dict(), model.model_args()), params)
    again = TB.to_state_dict(name, TB.to_flax(name, model.state_dict(), model.model_args()),
                             model.model_args())
    assert all(torch.equal(again[k], v) for k, v in model.state_dict().items())
    TM.save_model(model, tmp_path / "port.pkl")
    jm, jp = JM.from_pretrain(tmp_path / "port.pkl")
    assert type(jm).__name__ == name
    _equal(jax.tree.map(np.asarray, jp), params)
    JM.save_model(JM.get(name)(**cfg), jax.tree.map(jnp.asarray, params), tmp_path / "jax.pkl")
    ours = TM.from_pretrain(tmp_path / "jax.pkl", device="cpu")
    assert type(ours).__name__ == name and ours.model_args() == model.model_args()
    _equal(TB.to_flax(name, ours.state_dict(), ours.model_args()), params)


@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
def test_bidirectional_sequence_model(kind):
    """``SequenceModel(bidirectional=True)`` with two layers: cells 2i and
    2i + 1 are layer i's forward and backward directions."""
    jm = JS.SequenceModel(6, 8, 2, bidirectional=True, sequence_model=kind)
    x = np.random.default_rng(2).standard_normal((2, 11, 5)).astype(np.float32)
    model = TS.SequenceModel(5, 6, 8, 2, kind, "Tanh", bidirectional=True)
    spec = bridge._seq_model("m", "m", bidirectional=True)
    tree = bridge._spec_to_flax({f"m.{k}": v for k, v in model.state_dict().items()}, spec)
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    assert sorted(jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(
        tree["params"]["m"])[0]) == sorted(jax.tree_util.keystr(p) for p, _ in
                                           jax.tree_util.tree_flatten_with_path(
                                               want["params"])[0])
    params = {"params": chip_smoke.seeded_flax(tree["params"]["m"], 3)}
    sd = bridge._spec_to_torch({"params": {"m": params["params"]}}, spec)
    model.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(jm.apply(params, x))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_gru_cell_is_flax_and_keeps_its_zero_thirds():
    """One ``GRULayer`` against ``flax.linen.GRUCell`` under ``nn.RNN``: a
    reference checkpoint's nonzero ``bias_hh`` r and z thirds add into
    flax's input biases, and an Adam step (with decoupled decay) leaves
    them where they are, zero or not."""
    import flax.linen as fnn

    torch.manual_seed(0)
    layer = GRULayer(5, 7)
    with torch.no_grad():
        layer.bias_hh_l0.normal_()
    x = torch.randn(3, 9, 5)
    tree = bridge._stack_to_flax({f"g.{k}": v for k, v in layer.state_dict().items()}, "g")
    ref = fnn.RNN(fnn.GRUCell(7)).apply({"params": {"cell": tree["GRUCell_0"]}}, x.numpy())
    np.testing.assert_allclose(layer(x).detach().numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    for start in (layer.bias_hh_l0.detach().clone(), torch.zeros(21)):
        with torch.no_grad():
            layer.bias_hh_l0.copy_(start)
        opt = make_optimizer([p for p in layer.parameters()], 1e-2, 0.1, "adamw")
        opt.zero_grad()
        layer(x).square().sum().backward()
        assert not layer.bias_hh_l0.grad[:14].any() and layer.bias_hh_l0.grad[14:].any()
        opt.step()
        assert torch.equal(layer.bias_hh_l0[:14], start[:14] * (1 - 1e-2 * 0.1)) or (
            not start[:14].any() and not layer.bias_hh_l0[:14].any())


# The GRU FastFullSubnet's float32 gradients lie 7.6e-4 · max|g64| from
# JAX's float64 step in the JAX package and 3.2e-5 in the port: JAX in
# float64 referees its step.
STEP_F64 = ("fastfullsubnet-gru",)
ADAM_EPS = 1e-8  # optax.adam's, the JAX factory's


@pytest.mark.parametrize("case", [c for c in IDS if c != "inter_subnet-gru"])
def test_f32_step_matches_optax(case):
    name, cfg, _ = VARIANTS[case]
    j_loss, t_loss = _losses(name)
    mix, clean = _batch()
    params = jax_params(name, cfg)
    jm, model = JM.get(name)(**cfg), port(name, cfg, params).train()
    args = model.model_args()
    opt = j_make_optimizer(LR, clip_norm=CLIP)
    p1, state, j_val = jax.jit(j_make_train_step(jm, j_loss, opt))(
        params, opt.init(params), jnp.asarray(mix), jnp.asarray(clean))
    j_grads = jax.tree.map(lambda m: m / 0.1, adam_mu(state))  # mu = (1 − b1) · g

    step = make_train_step(model, t_loss, make_optimizer(model, LR), clip_norm=CLIP)
    val = float(step(torch.from_numpy(mix), torch.from_numpy(clean)))
    np.testing.assert_allclose(val, float(j_val), rtol=LOSS_REL)
    if case in STEP_F64:
        _step_to_jax_float64(name, cfg, params, (jm, j_loss, opt), t_loss, (mix, clean),
                             j_grads, model)
        return
    to_port = lambda tree: TB.to_state_dict(name, jax.tree.map(np.asarray, tree), args)  # noqa
    want_g, want_p = to_port(j_grads), to_port(p1)
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    g_max = max(float(want_g[n].abs().max()) for n in grads)
    for n, g in grads.items():
        np.testing.assert_allclose(g, want_g[n], rtol=0, atol=GRAD_REL * g_max, err_msg=n)
        atol = torch.where(want_g[n].abs() < NOISE_SHARE * g_max, 2 * LR, PARAM_ATOL)
        p = dict(model.named_parameters())[n].detach()
        assert bool(((p - want_p[n]).abs() <= atol).all()), n


def _flax_leaves(name, model, tensors) -> list:
    """``tensors`` (the port's names, float64; a name it lacks, 0) in the
    flax layout, as the JAX step's ``params`` leaves."""
    sd = {k: tensors[k].double() if k in tensors else torch.zeros_like(v, dtype=torch.float64)
          for k, v in model.state_dict().items()}
    return _params(TB.to_flax(name, sd, model.model_args()))


def _step_to_jax_float64(name, cfg, params, j_step, t_loss, batch, j_grads, model):
    """One Adam step of the JAX package in float64 referees the port's
    float32 step (``model``, taken): the port's float64 gradients within
    ``F64_REL`` · max|g64| and its parameters within ``F64_REL`` ·
    max|Δp64| of it; its float32 gradients within max(``GRAD_REL``,
    ``ILL_FACTOR`` x JAX's float32 distance from float64) · max|g64|, and
    its float32 parameters by test_torch_enh_train.py's rule."""
    jm, j_loss, opt = j_step
    mix, clean = batch
    with jax_float64():
        p64 = _to_f64(params)
        q64, state64, _ = jax.jit(j_make_train_step(jm, j_loss, opt))(
            p64, opt.init(p64), jnp.asarray(mix, jnp.float64), jnp.asarray(clean, jnp.float64))
        g64 = [np.asarray(m) / 0.1 for m in _params(adam_mu(state64))]
    q64, p0 = (_params(jax.tree.map(np.asarray, t)) for t in (q64, p64))
    assert all(v.dtype == np.float64 for v in g64 + q64)
    g_max = max(float(np.abs(g).max()) for g in g64)
    moved = _dist(q64, p0)

    ours64 = port(name, cfg, params).train().double()
    step = make_train_step(ours64, t_loss, make_optimizer(ours64, LR), clip_norm=CLIP)
    step(torch.from_numpy(mix).double(), torch.from_numpy(clean).double())
    named = dict(ours64.named_parameters())
    delta = chip_smoke.F64_REL * g_max
    assert _dist(_flax_leaves(name, ours64, {n: p.grad for n, p in named.items()
                                            if p.grad is not None}), g64) <= delta
    # Adam's first step moves a parameter by lr · g / (|g| + eps): gradients
    # within delta of each other move it within lr · eps · delta / (|g| −
    # delta + eps)² of each other, as much as F64_REL · max|Δp64| only
    # where |g| is well above eps.
    for got, want, g in zip(_flax_leaves(name, ours64, {n: p.detach() for n, p in named.items()}),
                            q64, g64):
        slack = LR * ADAM_EPS * delta / (np.maximum(np.abs(g) - delta, 0) + ADAM_EPS) ** 2
        assert bool((np.abs(np.asarray(got) - want) <= chip_smoke.F64_REL * moved + slack).all())

    named = dict(model.named_parameters())
    got_g = _flax_leaves(name, model, {n: p.grad for n, p in named.items() if p.grad is not None})
    got_p = _flax_leaves(name, model, {n: p.detach() for n, p in named.items()})
    rel = max(GRAD_REL, chip_smoke.ILL_FACTOR * _dist(_params(j_grads), g64) / g_max)
    for g, p, want_g, want_p in zip(got_g, got_p, g64, q64):
        np.testing.assert_allclose(g, want_g, rtol=0, atol=rel * g_max)
        atol = np.where(np.abs(want_g) < NOISE_SHARE * g_max, 2 * LR, PARAM_ATOL)
        assert bool((np.abs(np.asarray(p) - want_p) <= atol).all())


# --- bf16 -------------------------------------------------------------------------

_READINGS = {}


def readings(case) -> Readings:
    if case not in _READINGS:
        name, cfg, _ = VARIANTS[case]
        params = jax_params(name, cfg)
        _READINGS[case] = Readings(name, cfg, params, port(name, cfg, params),
                                   JM.get(name)(**cfg), 1)
    return _READINGS[case]


@pytest.mark.parametrize("case", IDS)
def test_bf16_verdict(case):
    """A variant the port serves in bf16 lies within the gate three ways
    (JAX bf16 vs JAX fp32, port vs port, port bf16 vs JAX bf16); a refused
    one is refused by name and variant with its reason."""
    name, cfg, _ = VARIANTS[case]
    r = readings(case)
    label = variant_name(r.model)
    if label in BF16_MODELS:
        check_forward(r)
        return
    assert label in BF16_REFUSED
    check_refused(re_escape(label), r.model, BF16_REFUSED[label])
    j32, j16, t32, t16 = r.served()  # a full-width verdict: within the gate here
    assert max(rel_l2(j16, j32), rel_l2(t16, t32)) < 0.05 and rel_l2(t16, j16) < 1e-3


def test_gagnet_unet_is_over_the_gate_at_full_width():
    """GaGNet(is_u2=False) at gagnet.yaml's other widths (d_feat 256 = 64
    channels x 4 bins) on 0.5 s of a 220 Hz tone in noise: bf16 lies over
    the gate from float32 in both packages, which agree with each other (as
    GaGNet's own, tests/test_torch_bf16_enh.py); within it at the tests'
    small width. The port refuses the variant."""
    name, args = chip_smoke.ENH_MODELS["gagnet"]
    args = dict(args, is_u2=False)
    model = chip_smoke.seeded_zoo(name, args, 0).eval()
    params = TB.to_flax(name, model.state_dict(), model.model_args())
    jm = JM.get(name)(**args)
    t = 8000
    rng = np.random.default_rng(0)
    x = (0.3 * np.sin(2 * np.pi * 220 * np.arange(t) / 16000)[None]
         + 0.01 * rng.standard_normal((1, t))).astype(np.float32)
    j32, j16 = (np.asarray(JI.to_waveform(jm, jax.jit(f)(params, x), t))
                for f in (jm.apply, j_bf16_forward(jm)))
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        t32 = to_waveform(model, model(xt), t).numpy()
        t16 = to_waveform(model, to_float32(bf16_call(model, cast_state(model), xt)), t).numpy()
    assert rel_l2(j16, j32) > 0.05 and rel_l2(t16, t32) > 0.05
    assert rel_l2(t16, j16) < 1e-3 and rel_l2(t32, j32) < 1e-3
    check_refused(re_escape(variant_name(model)), model, "over the zoo's 0.05 gate")


def re_escape(label: str) -> str:
    import re

    return re.escape(label)


def test_variant_labels():
    """``require_bf16`` decides by the model and its variant: a variant no
    verdict names is refused, never served as its config's model."""
    for case, (name, cfg, _) in VARIANTS.items():
        model = TM.get(name)(**cfg, device="cpu")
        label = variant_name(model)
        assert label == name if case == "inter_subnet-gru" else label.startswith(f"{name}(")
        assert label in BF16_MODELS or label in BF16_REFUSED
    unlisted = TM.get("Fullband")(**dict(ENH_SMALL["Fullband"], sequence_model="RNN"),
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="sequence_model='RNN'"):
        require_bf16(unlisted)
    with pytest.raises(NotImplementedError, match="sequence_model='RNN'"):
        bf16_forward(unlisted)
