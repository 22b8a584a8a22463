"""The enhancement zoo in the port against the JAX package, with the same
seeded weights carried across by the bridge: each model's forward at small
width (every output of the tuple), the conv-STFT pair, ``freq_unfold``,
``mel_filterbank``, ``GroupedConv1D`` and the cIRM's inference half.

Tolerance: max abs diff ≤ 1e-5 · max|ref| (float32 LSTMs, convolutions and
FFTs summed in another order; measured 1.2e-7 to 1.5e-6), but where the
model is ill-conditioned in float32 and both sides lie as far from the
port's float64 forward on the CPU as from each other:

* FullSubNet+: 1e-4 (measured 5.2e-5; the JAX forward lies 4.6e-5 and the
  port's float32 9.8e-5 from the port in float64: eight TCN blocks whose
  GroupNorms have epsilon 1e-8);
* Inter-SubNet: 3e-5 (measured 1.4e-5; the JAX forward lies 1.4e-5 and the
  port's 1.5e-6 from float64);
* FRCRN: 1e-4 (measured 6.6e-5 on the second stage's mask; the JAX forward
  lies 5.7e-5 and the port's 3.3e-5 from float64: two cascaded 14-layer
  UNets of batch-statistics BatchNorms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sonicsim_tpu.losses.cirm as JC
import sonicsim_tpu.models as JM
from sonicsim_tpu.models import dccrn as JD
from sonicsim_tpu.models import fastfullsubnet as JF
from sonicsim_tpu.models import fullsubnet as JS
from sonicsim_tpu.models.layers import GroupedConv1D as JaxGroupedConv1D
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.losses import cirm as TC
from sonicsim_tpu_torch.models import base as TB
from sonicsim_tpu_torch.models import dccrn as TD
from sonicsim_tpu_torch.models import fastfullsubnet as TF
from sonicsim_tpu_torch.models import fullsubnet as TS
from sonicsim_tpu_torch.models.layers import GroupedConv1D
from torch_threads import one_intra_op_thread  # noqa: F401

REL = 1e-5
STFT = dict(n_fft=256, hop_length=128, win_length=256, num_freqs=129)
# tests/test_enhancement.py's small widths; FastFullSubnet, FRCRN and
# BSRNN-ESPnet fix their other widths (and FFTs) themselves.
SMALL = {
    "Fullband": dict(hidden_size=16, **STFT),
    "FullSubnet": dict(fb_model_hidden_size=16, sb_model_hidden_size=8, sb_num_neighbors=2, **STFT),
    "FastFullSubnet": dict(bottleneck_hidden_size=8),
    "FullSubNet_Plus": dict(sb_model_hidden_size=8, **STFT),
    "Inter_SubNet": dict(sb_model_hidden_size=8, **STFT),
    "DCCRN": dict(rnn_units=32, kernel_num=(8, 16, 32), rnn_layers=2),
    "FRCRN": dict(),
    "BSRNNESPNet": dict(num_channels=8, num_layers=1),
}
CASES = list(SMALL.items()) + [
    ("DCCRN", dict(SMALL["DCCRN"], torch_compat=True, masking_mode="C")),  # frozen statistics
]
TOL = {"FullSubNet_Plus": 1e-4, "Inter_SubNet": 3e-5, "FRCRN": 1e-4}
T = 3200


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out.numpy() if torch.is_tensor(out) else np.asarray(out)]


_PARAMS = {}


def jax_layout(tree) -> list:
    """A parameter tree's leaves as (path, shape), in path order."""
    return sorted((jax.tree_util.keystr(path), tuple(np.shape(v)))
                  for path, v in jax.tree_util.tree_flatten_with_path(tree)[0])


def jax_params(name, cfg, seed=0):
    """The JAX model's parameter tree filled by chip_smoke.py's seeded draw,
    a frozen-statistics ``var`` made positive; made once per model and
    arguments. The tree is the bridge's layout of the port's state dict,
    held leaf for leaf, path and shape, to the JAX init's own
    (``jax.eval_shape``, a trace without compiling, once per arguments)."""
    key = (name, repr(sorted(cfg.items())), seed)
    if key not in _PARAMS:
        model = TM.get(name)(**cfg, device="cpu")
        tree = TB.to_flax(name, model.state_dict(), model.model_args())
        want = jax.eval_shape(JM.get(name)(**cfg).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, T), jnp.float32))
        assert jax_layout(tree) == jax_layout(want), name
        params = chip_smoke.seeded_flax(tree, seed)
        _PARAMS[key] = jax.tree_util.tree_map_with_path(
            lambda path, v: np.abs(v) + 0.5 if path[-1].key == "var" else v, params)
    return _PARAMS[key]


def port(name, cfg, params):
    model = TM.get(name)(**cfg, device="cpu")
    model.load_state_dict(TB.to_state_dict(name, params, model.model_args()))
    return model.eval()


@pytest.mark.parametrize("name,cfg", CASES, ids=lambda v: v if isinstance(v, str) else "")
def test_small_width_forward(name, cfg):
    params = jax_params(name, cfg)
    x = (0.3 * np.random.default_rng(1).standard_normal((2, T))).astype(np.float32)
    ref = _leaves(jax.jit(JM.get(name)(**cfg).apply)(params, x))
    with torch.inference_mode():
        ours = _leaves(port(name, cfg, params)(torch.from_numpy(x)))
    assert len(ours) == len(ref)
    rel = TOL.get(name, REL)
    for got, want in zip(ours, ref):
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("win,hop,fft,sqrt_window,pad_signal",
                         [(400, 100, 512, False, True), (640, 320, 640, True, False)],
                         ids=["dccrn", "frcrn"])
def test_conv_stft_and_istft(win, hop, fft, sqrt_window, pad_signal):
    rng = np.random.default_rng(2)
    x = (0.3 * rng.standard_normal((2, 4000))).astype(np.float32)
    ref = [np.asarray(a) for a in JD.conv_stft(jnp.asarray(x), win, hop, fft, sqrt_window,
                                               pad_signal)]
    ours = [a.numpy() for a in TD.conv_stft(torch.from_numpy(x), win, hop, fft, sqrt_window,
                                            pad_signal)]
    for got, want in zip(ours, ref):
        np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
    real, imag = (a + 0.1 * rng.standard_normal(a.shape).astype(np.float32) for a in ref)
    want = np.asarray(JD.conv_istft(jnp.asarray(real), jnp.asarray(imag), win, hop, fft, 4000,
                                    sqrt_window, crop_pad=pad_signal))
    got = TD.conv_istft(torch.from_numpy(real), torch.from_numpy(imag), win, hop, fft, 4000,
                        sqrt_window, crop_pad=pad_signal).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
    np.testing.assert_array_equal(TD._istft_pinv(win, fft), JD._istft_pinv(win, fft))
    np.testing.assert_array_equal(TD._hann(win), JD._hann(win))


@pytest.mark.parametrize("n", [0, 2, 15])
def test_freq_unfold(n):
    x = np.random.default_rng(3).standard_normal((2, 33, 7)).astype(np.float32)
    np.testing.assert_array_equal(TS.freq_unfold(torch.from_numpy(x), n).numpy(),
                                  np.asarray(JS.freq_unfold(jnp.asarray(x), n)))


def test_mel_filterbank():
    for args in ((257, 64, 16000, 0.0, 8000.0), (129, 40, 16000, 0.0, None)):
        np.testing.assert_array_equal(TF.mel_filterbank(*args), JF.mel_filterbank(*args))


@pytest.mark.parametrize("k,dilation,groups,padding", [
    (3, 2, 16, [(2, 2)]), (20, 1, 16, "VALID"), (4, 1, 4, "SAME"), (3, 1, 1, [(1, 0)])])
def test_grouped_conv1d(k, dilation, groups, padding):
    x = np.random.default_rng(4).standard_normal((2, 50, 16)).astype(np.float32)  # (B, T, C)
    jm = JaxGroupedConv1D(16, (k,), padding=padding, kernel_dilation=(dilation,),
                          feature_group_count=groups)
    params = chip_smoke.seeded_flax(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 5)
    want = np.asarray(jm.apply(params, x))
    conv = GroupedConv1D(16, 16, k, padding=padding if isinstance(padding, str) else padding[0],
                         dilation=dilation, groups=groups)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(params["params"]["kernel"].transpose(2, 1, 0).copy()))
        conv.bias.copy_(torch.from_numpy(params["params"]["bias"]))
        got = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


def test_cirm_inference():
    rng = np.random.default_rng(5)
    crm = rng.uniform(-12, 12, (2, 2, 129, 30)).astype(np.float32)
    real, imag = (rng.standard_normal((2, 129, 30)).astype(np.float32) for _ in range(2))
    for n_fft, win in ((256, None), (256, 200)):
        want = np.asarray(JC.cirm_inference((crm, real, imag), n_fft, 128, 3700, win))
        got = TC.cirm_inference(tuple(map(torch.from_numpy, (crm, real, imag))), n_fft, 128,
                                3700, win).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
    m = rng.uniform(-150, 50, (4, 9)).astype(np.float32)
    np.testing.assert_allclose(TC.compress_cirm(torch.from_numpy(m)).numpy(),
                               np.asarray(JC.compress_cirm(jnp.asarray(m))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TC.decompress_cirm(torch.from_numpy(m / 10)).numpy(),
                               np.asarray(JC.decompress_cirm(jnp.asarray(m / 10))), rtol=1e-6,
                               atol=1e-5)
