"""PyanNet in the port against the JAX package, on the CPU, with the same
seeded weights (``chip_smoke.seeded_flax`` over the JAX init's shapes,
carried across by ``bridge.pyannet_from_flax``) at a small LSTM width:
``sinc_filters``, the forward's frame probabilities, ``frame_times``,
``binarize_activations``, and ``make_neural_vad`` from seeded pyannote-style
checkpoint files (a lightning ``model.`` prefix, nonzero ``bias_ih`` and
``bias_hh``, the cutoffs with or without ``filterbank.`` and as (F, 1)).

Tolerances: the sinc bank within 1e-5 · max|ref| (float32 sin of
arguments up to ~370 rad, where an ulp is 3e-5; measured 1.2e-6);
probabilities within 1e-5 (float32 LSTMs summed in another order); frame
times and binarised spans equal; the VAD's spans equal to the JAX VAD's
except where a frame's probability lies within 1e-5 of onset or offset
(``chip_smoke.vad_spans_held``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sonicsim_tpu.models.pyannet as JP
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch.models import pyannet as TP
from torch_threads import one_intra_op_thread  # noqa: F401

SR = 16000
PROB_TOL = 1e-5
SMALL = dict(lstm_hidden=16, lstm_layers=2, ff_layers=2)


def jax_params(seed=0, widths=SMALL):
    """The JAX PyanNet's tree filled by chip_smoke.py's seeded draw, its
    sinc cutoffs spread over the band (``chip_smoke.seeded_sinc``) and its
    classifier's kernel 30 times the draw, its bias centring the logits of
    ``_speechy(6.0, 7)`` on 0, so that the probabilities cross 0.5 (the
    plain draw keeps them in [0.46, 0.50])."""
    model = JP.PyanNet(**widths)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, SR)))
    params = chip_smoke.seeded_flax(tree["params"], seed)
    low, band = chip_smoke.seeded_sinc(80, seed)
    params["sincnet"]["sinc"] = {"low_hz": low, "band_hz": band}
    head = params["classifier"]
    head["kernel"], head["bias"] = 30 * head["kernel"], np.zeros_like(head["bias"])
    p = np.asarray(model.apply({"params": params}, jnp.asarray(_speechy(6.0, 7))[None]))
    head["bias"] = np.full_like(head["bias"], -np.median(np.log(p / (1 - p))))
    return model, {"params": params}


def write_checkpoint(path, params, style="pyannote"):
    """A pyannote-style checkpoint of ``params``: ``state_dict`` under a
    lightning ``model.`` prefix, the bias split between ``bias_ih`` and
    ``bias_hh``; ``style="bare"`` keeps the cutoffs at
    ``sincnet.conv1d.0.low_hz_`` as (F, 1), no prefix."""
    sd = dict(bridge.pyannet_from_flax(params))
    for k in [k for k in sd if ".bias_ih_" in k]:
        half = 0.5 * sd[k]
        sd[k], sd[k.replace("bias_ih", "bias_hh")] = half, half.clone()
    if style == "bare":
        for name in ("low_hz_", "band_hz_"):
            sd[f"sincnet.conv1d.0.{name}"] = sd.pop(f"sincnet.conv1d.0.filterbank.{name}")[:, None]
        torch.save(sd, path)
    else:
        torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}}, path)
    return path


def _speechy(seconds, seed=0):
    """Bursts of a tone over a noise floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    gate = (np.sin(2 * np.pi * 0.7 * t) > 0.2).astype(np.float64)
    x = 0.3 * gate * np.sin(2 * np.pi * 220 * t) + 0.01 * rng.standard_normal(t.size)
    return x.astype(np.float32)


def test_sinc_filters():
    low, band = chip_smoke.seeded_sinc(80, 0)
    for k in (251, 129):
        ref = np.asarray(JP.sinc_filters(jnp.asarray(low), jnp.asarray(band), k, SR))
        got = TP.sinc_filters(torch.from_numpy(low), torch.from_numpy(band), k, SR).numpy()
        assert got.shape == ref.shape == (80, k)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(seed):
    jm, params = jax_params(seed)
    model = TP.PyanNet(**SMALL, device="cpu").eval()
    model.load_state_dict(bridge.pyannet_from_flax(params))
    wav = np.stack([_speechy(2.0, seed), _speechy(2.0, seed + 5) * 0.1])
    ref = np.asarray(jm.apply(params, jnp.asarray(wav)))
    with torch.no_grad():
        got = model(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape and got.shape[:2] == (2, len(model.frame_times(2 * SR)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=PROB_TOL)


def test_frame_times_and_binarize():
    ours, ref = TP.PyanNet(device="cpu"), JP.PyanNet()
    for n in (0, 300, 16000, 16001, 60 * SR):
        np.testing.assert_array_equal(ours.frame_times(n), ref.frame_times(n))
    rng = np.random.default_rng(3)
    probs = np.clip(np.cumsum(rng.standard_normal(400)) * 0.05 + 0.5, 0, 1)
    times = ref.frame_times(400 * 270 + 1000)[:400]
    for kw in (dict(), dict(onset=0.6, offset=0.4), dict(min_duration_on=0.1),
               dict(min_duration_off=0.2, pad_onset=0.05, pad_offset=0.02)):
        assert TP.binarize_activations(probs, times, **kw) == JP.binarize_activations(
            probs, times, **kw)


@pytest.mark.parametrize("style", ["pyannote", "bare"])
def test_neural_vad_from_a_checkpoint(tmp_path, style):
    jm, params = jax_params(2)
    ckpt = write_checkpoint(tmp_path / "pyannet.ckpt", params, style)
    ours, ref = TP.make_neural_vad(ckpt, device="cpu"), JP.make_neural_vad(ckpt)
    wav = _speechy(6.0, 7)
    with torch.no_grad():
        got = ours.model(torch.from_numpy(wav)[None])[0].amax(-1).numpy()
    want = np.asarray(jm.apply(params, jnp.asarray(wav)[None]))[0].max(-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)
    times = ours.model.frame_times(len(wav))
    spans = ours(wav, SR)
    assert spans and spans == [(int(s * SR), int(e * SR)) for s, e in TP.binarize_activations(
        got, times)]
    assert chip_smoke.vad_spans_held(got, want, times, PROB_TOL)
    assert ref(wav, SR) == [(int(s * SR), int(e * SR))
                            for s, e in JP.binarize_activations(want, times)]
    down = wav[::2].copy()  # 8 kHz: resampled to the model's 16 kHz
    assert len(ours(down, 8000)) == len(ref(down, 8000))
