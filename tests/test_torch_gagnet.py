"""The GaGNet family (GaGNet, G2Net, TaylorSENet) in the port against the JAX
package, at small widths, with the same seeded weights carried across by
the bridge: the layers with a layout trap (the transposed convs and their
trailing-time chomp, the frequency crops, the instance norms, TaylorSENet's
eps-1.0 parameterless one among them, the causal and the centred dilated
convs, the channel-major flattens), each model's forward and
``to_waveform``, and the bridge (the port's ``<name>_flax_params`` equal to
the JAX converter leaf for leaf, flax → torch → flax exact, torch → flax →
torch the same function).

Narrowing: ``d_feat`` must be the encoder's 64 channels times its frequency
bins, so the models narrow through ``c``, ``cd1``, ``p``/``q``/``tcn_num``/
``order_num``, the dilations and a 256-point FFT (d_feat 192), on 3,200
samples. The inputs are seeded noise, whose spectra have no zero bins.

Tolerance: max abs diff ≤ 1e-5 · max|ref| (float32 convolutions and FFTs
summed in another order); the layers 1e-5 · max|ref| too, the flattens
exact. Each JAX model is built and jitted once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sonicsim_tpu.infer as JI
import sonicsim_tpu.models as JM
from sonicsim_tpu.models import g2net as JG2
from sonicsim_tpu.models import gagnet as JG
from sonicsim_tpu.models import taylorsenet as JT
from sonicsim_tpu.models.torch_import import import_torch_checkpoint
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.infer import to_waveform
from sonicsim_tpu_torch.models import base as TB
from sonicsim_tpu_torch.models import g2net as TG2
from sonicsim_tpu_torch.models import gagnet as TG
from sonicsim_tpu_torch.models import taylorsenet as TT
from torch_threads import one_intra_op_thread  # noqa: F401

REL = 1e-5
T = 3200
STFT = dict(fft_num=256, n_fft=256, hop_length=128, win_length=256)
SMALL = {
    "GaGNet": dict(c=8, cd1=8, d_feat=192, p=1, q=2, dilas=(1, 2), **STFT),
    "G2Net": dict(c=8, cd1=8, d_feat=192, tcn_num=1, dilas=(1, 2), stage_num=2, **STFT),
    "TaylorSENet": dict(c=8, cd1=8, d_feat=192, p=1, order_num=2, dilations=(1, 2), **STFT),
}
CASES = list(SMALL.items()) + [
    ("GaGNet", dict(SMALL["GaGNet"], is_causal=False, acti_type="tanh", intra_connect="add")),
    ("G2Net", dict(SMALL["G2Net"], head_type="MAG", acti_type="relu")),
]
IDS = ["GaGNet", "G2Net", "TaylorSENet", "GaGNet-noncausal-add", "G2Net-MAG"]


def jax_params(name, cfg, seed=0):
    """The JAX model's parameter tree, filled by chip_smoke.py's seeded draw:
    the bridge's layout of the port's state dict, which
    ``test_flax_params_equal_the_jax_converter`` holds to the JAX converter
    and on which the JAX forward raises where a leaf is missing; it spares
    a trace of the JAX init."""
    model = TM.get(name)(**cfg, device="cpu")
    return chip_smoke.seeded_flax(TB.to_flax(name, model.state_dict(), model.model_args()), seed)


def port(name, cfg, params):
    model = TM.get(name)(**cfg, device="cpu")
    model.load_state_dict(TB.to_state_dict(name, params, model.model_args()))
    return model.eval()


def noise(shape, seed=1):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _list(out):
    return list(out) if isinstance(out, list) else [out]


@pytest.fixture(scope="module")
def references():
    """Per case: the seeded flax params and the JAX forward on the input,
    each model jitted once."""
    x = noise((2, T))
    out = {}
    for i, (name, cfg) in zip(IDS, CASES):
        params = jax_params(name, cfg)
        jm = JM.get(name)(**cfg)

        def fwd(p, v, jm=jm):
            spec = jm.apply(p, v)
            return spec, JI.to_waveform(jm, spec, T)

        spec, wav = jax.jit(fwd)(params, x)
        out[i] = (params, [np.asarray(s) for s in _list(spec)], np.asarray(wav))
    return x, out


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_forward_and_to_waveform(case, references):
    name, cfg = CASES[case]
    x, refs = references
    params, spec, wav = refs[IDS[case]]
    model = port(name, cfg, params)
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
        got_wav = to_waveform(model, out, T)
    got = _list(out)
    assert len(got) == len(spec)
    for g, w in zip(got, spec):
        _close(g.numpy(), w)
    assert got_wav.shape == (2, 1, T)
    _close(got_wav.numpy(), wav)


def _reference_state_dict(name, cfg, seed=0):
    """A state dict under the reference's names, every entry drawn from a
    seed, as numpy."""
    g = torch.Generator().manual_seed(seed)
    model = TM.get(name)(**cfg, device="cpu")
    return {k: (v + 0.1 * torch.randn(v.shape, generator=g)).numpy()
            for k, v in model.state_dict().items()}


def _leaves_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


@pytest.mark.parametrize("case", range(4), ids=IDS[:4])
def test_flax_params_equal_the_jax_converter(case):
    """(The JAX converter reads both of G2Net's heads, so a one-head G2Net
    has none.)"""
    name, cfg = CASES[case]
    sd = _reference_state_dict(name, cfg)
    ours = TB.to_flax(name, sd, dict(cfg))
    _, ref = import_torch_checkpoint({"model_name": name, "model_args": {}, "state_dict": sd},
                                     model=JM.get(name)(**cfg))
    _leaves_equal(ours, jax.tree.map(np.asarray, ref))


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_round_trips(case, references):
    """flax → torch → flax exactly; torch → flax → torch the same function."""
    name, cfg = CASES[case]
    x, refs = references
    params = refs[IDS[case]][0]
    model = port(name, cfg, params)
    _leaves_equal(TB.to_flax(name, model.state_dict(), model.model_args()), params)

    sd = _reference_state_dict(name, cfg)
    other = TM.get(name)(**cfg, device="cpu").eval()
    other.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    back = port(name, cfg, TB.to_flax(name, sd, other.model_args()))
    with torch.inference_mode():
        want, got = _list(other(torch.from_numpy(x[:1]))), _list(back(torch.from_numpy(x[:1])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_packs_cross_both_ways(tmp_path, references):
    """The port's pack of TaylorSENet loads in the JAX package with the same
    weights, and the JAX package's pack in the port."""
    name, cfg = CASES[2]
    params = references[1]["TaylorSENet"][0]
    TM.save_model(port(name, cfg, params), tmp_path / "port.pkl")
    jm, jp = JM.from_pretrain(tmp_path / "port.pkl")
    assert type(jm).__name__ == name
    _leaves_equal(jax.tree.map(np.asarray, jp), params)
    JM.save_model(JM.get(name)(**cfg), jax.tree.map(jnp.asarray, params), tmp_path / "jax.pkl")
    ours = TM.from_pretrain(tmp_path / "jax.pkl", device="cpu")
    _leaves_equal(TB.to_flax(name, ours.state_dict(), ours.model_args()), params)


# --- layers: each JAX module against the port's, channel-last against NCHW ---

def _layer_cases():
    """(id, JAX module, port module, bridge spec under ``m``, input shape in
    the JAX layout)."""
    b = bridge
    cat = 2 * 4
    return [
        ("deconv-unit-chomp", JT.Deconv2dUnitT(4, (2, 3)), TG.Deconv2dUnit(cat, 4, (2, 3), TT.NORM),
         [("m/deconv", "m.deconv.0", b._CONVT2D), ("m/prelu", "m.deconv.3", b._PRELU)],
         (2, 7, 9, cat)),
        ("gate-conv-transpose-chomp", JT.GateConvTranspose2d(4, (2, 3)),
         TT.GateConvTranspose2d(cat, 4, (2, 3)), b._gate_t("m", "m", (2, 3)), (2, 7, 9, cat)),
        ("decoder-unet-module", JT.EnUnetModuleT(4, (1, 3), (2, 3), 2, de_flag=True),
         TG.EnUnetModule(cat, 4, (1, 3), (2, 3), 2, gate=TT.GateConvTranspose2d, norm=TT.NORM),
         b._unet_spec("m", "m", (1, 3), (2, 3), 2, b._gate_t, None), (2, 6, 15, cat)),
        ("encoder-unet-module-eps1", JT.EnUnetModuleT(4, (1, 5), (2, 3), 3),
         TG.EnUnetModule(2, 4, (1, 5), (2, 3), 3, norm=TT.NORM),
         b._unet_spec("m", "m", (1, 5), (2, 3), 3, b._gate, None), (2, 6, 33, 2)),
        ("gagnet-unet-module-crops", JG.EnUnetModule(4, (2, 3), (1, 3), 3),
         TG.EnUnetModule(4, 4, (2, 3), (1, 3), 3),
         b._unet_spec("m", "m", (2, 3), (1, 3), 3, b._gate, b._IN), (2, 6, 63, 4)),
        ("g2net-gate-pair-module", JG.EnUnetModule(4, (2, 5), (1, 3), 1),
         TG.EnUnetModule(1, 4, (2, 5), (1, 3), 1, gate=TG2.Gate2dConv),
         b._unet_spec("m", "m", (2, 5), (1, 3), 1, b._gate_pair, b._IN), (2, 5, 33, 1)),
        ("squeezed-tcm-noncausal", JG.SqueezedTCM(3, 4, 6, 2, is_causal=False),
         TG.SqueezedTCM(3, 4, 6, 2, is_causal=False), b._squeezed_tcm("m", "m"), (2, 11, 6)),
        ("gated-tcm-eps1-causal", JG2.GatedSqueezedTCM(5, 4, 6, 2, norm_eps=1.0, norm_affine=False),
         TG2.GatedSqueezedTCM(5, 4, 6, 2, **TT.TCM),
         b._gated_tcm("m", "m", ("left_conv", "right_conv"), None), (2, 11, 6)),
    ]


LAYERS = _layer_cases()


def _to_port_layout(x):
    return np.moveaxis(x, -1, 1)


@pytest.mark.parametrize("case", range(len(LAYERS)), ids=[c[0] for c in LAYERS])
def test_layer(case):
    _, jm, tm, spec, shape = LAYERS[case]
    x = noise(shape, seed=case)
    params = chip_smoke.seeded_flax(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), case)
    want = _to_port_layout(np.asarray(jax.jit(jm.apply)(params, x)))
    sd = bridge._spec_to_torch({"params": {"m": params["params"]}}, spec)
    tm.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(_to_port_layout(x).copy())).numpy()
    _close(got, want)


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "eps1-no-affine"])
def test_instance_norm(affine):
    """JAX ``InstanceNorm`` (biased variance) on (B, T, F, C) against the
    port's on (B, C, T, F), TaylorSENet's eps 1.0 without parameters and
    GaGNet's affine one at its default eps."""
    x = 3.0 * noise((2, 5, 7, 4)) + 1.0
    eps = 1e-5 if affine else 1.0
    jm = JG.InstanceNorm(4, eps=eps, affine=affine)
    params = chip_smoke.seeded_flax(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 3)
    want = _to_port_layout(np.asarray(jm.apply(params, x)))
    tm = TG.NormSwitch(4) if affine else TG.InstanceNorm(4, eps=1.0, affine=False)
    assert len(list(tm.parameters())) == (2 if affine else 0)
    if affine:
        sd = bridge._IN[1](params["params"], "m")
        tm.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in sd.items()})
    got = tm(torch.from_numpy(_to_port_layout(x).copy())).detach().numpy()
    _close(got, want)


def test_flattens():
    """The channel-major (C, F) flatten of the encoder's output and the
    real-major (2, F) flatten of a stage spectrum, as the JAX models order
    them."""
    h = noise((2, 5, 7, 4))  # JAX (B, T, F, C)
    want = np.swapaxes(h, 2, 3).reshape(2, 5, 28)  # gagnet.py:327-329
    got = TG.flatten_channels(torch.from_numpy(_to_port_layout(h).copy())).numpy()
    np.testing.assert_array_equal(got, np.moveaxis(want, -1, 1))
    pre = noise((2, 5, 7, 2))  # JAX (B, T, F, 2)
    want = np.swapaxes(pre, 2, 3).reshape(2, 5, 14)  # gagnet.py:231
    got = torch.from_numpy(np.transpose(pre, (0, 3, 2, 1)).copy()).reshape(2, 14, 5).numpy()
    np.testing.assert_array_equal(got, np.moveaxis(want, -1, 1))
    term = noise((2, 2, 5, 7))  # TaylorSENet (B, 2, T, F)
    want = np.transpose(term, (0, 2, 1, 3)).reshape(2, 5, 14)  # taylorsenet.py:257
    got = torch.from_numpy(term).transpose(2, 3).reshape(2, 14, 5).numpy()
    np.testing.assert_array_equal(got, np.moveaxis(want, -1, 1))


def test_compressed_spectrum():
    x = noise((2, T))
    spec, mag, phase = TG.compressed_spectrum(torch.from_numpy(x), 256, 128)
    xj = jnp.asarray(x) * jnp.sqrt(T / jnp.sum(jnp.asarray(x) ** 2, -1, keepdims=True))
    from sonicsim_tpu.ops.stft import hann_window, stft

    sj = jnp.swapaxes(stft(xj, 256, 128, hann_window(256)), 1, 2)
    mj = np.asarray(jnp.sqrt(jnp.abs(sj)))
    _close(mag.numpy(), mj)
    _close(spec.numpy(), np.stack([mj * np.cos(np.asarray(jnp.arctan2(sj.imag, sj.real))),
                                   mj * np.sin(np.asarray(jnp.arctan2(sj.imag, sj.real)))], 1))
