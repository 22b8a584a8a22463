"""ECAPA-TDNN in the port against the JAX package, on the CPU, with the same
seeded weights (``chip_smoke.seeded_flax`` over the JAX init's shapes,
carried across by ``bridge.ecapa_from_flax``) at a small width: the
speechbrain mel bank and ``ecapa_fbank``, the forward, and
``make_ecapa_embedder`` from a seeded speechbrain-format checkpoint file
(``num_batches_tracked`` entries included, ``fc.conv.bias`` present or
not) at 16 and 8 kHz (``inference --ecapa`` against the JAX flow is
tests/test_torch_serve.py's).

Tolerances: the mel bank equal (numpy copies); the fbanks within
1e-5 · max|ref| dB (float32 FFTs summed in another order: a bin far under
its frame's peak carries the peak's rounding; measured 1.1e-4 dB of about
20); the forward and the embeddings within 1e-4 · max|ref| (float32
through 13 BatchNorm'd convolutions; measured 1.9e-5) and cosine
≥ 1 − 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sonicsim_tpu.models.ecapa as JE
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch.models import ecapa as TE
from torch_threads import one_intra_op_thread  # noqa: F401

SR = 16000
REL = 1e-4
FBANK_REL = 1e-5
SMALL = dict(n_feats=80, channels=32, res2net_scale=4, se_channels=8, attention_channels=8,
             lin_neurons=16)


def jax_params(seed=0, widths=SMALL):
    """The JAX EcapaTdnn's tree filled by chip_smoke.py's seeded draw, the
    BatchNorms' running variances made positive."""
    model = JE.EcapaTdnn(**widths)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 20, widths["n_feats"])))
    params = chip_smoke.seeded_flax(tree["params"], seed)

    def fix(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fix(v)
            elif k == "var":
                node[k] = (0.5 + np.abs(v)).astype(np.float32)

    fix(params)
    return model, {"params": params}


def write_checkpoint(path, params, fc_bias=True):
    """A speechbrain embedding_model.ckpt of ``params``: the port's state
    dict (speechbrain's names) with each BatchNorm's num_batches_tracked."""
    sd = dict(bridge.ecapa_from_flax(params))
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(1000)
    if not fc_bias:
        del sd["fc.conv.bias"]
    torch.save(sd, path)
    return path


def _audio(seconds, seed=0, sr=SR):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.2 * np.sin(2 * np.pi * 180 * t) * (1 + np.sin(2 * np.pi * 2 * t))
    return (x + 0.03 * rng.standard_normal(t.size)).astype(np.float32)


def test_mel_bank_and_fbank():
    for args in ((16000, 400, 80), (8000, 256, 40)):
        np.testing.assert_array_equal(TE.speechbrain_mel_fb(*args), JE.speechbrain_mel_fb(*args))
    wav = np.stack([_audio(1.0, 0), _audio(1.0, 1) * 0.01])
    got = TE.ecapa_fbank(torch.from_numpy(wav)).numpy()
    ref = np.asarray(JE.ecapa_fbank(jnp.asarray(wav)))
    assert got.shape == ref.shape == (2, 101, 80)
    np.testing.assert_allclose(got, ref, rtol=0, atol=FBANK_REL * np.abs(ref).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(seed):
    jm, params = jax_params(seed)
    model = TE.EcapaTdnn(**SMALL, device="cpu").eval()
    model.load_state_dict(bridge.ecapa_from_flax(params))
    feats = np.random.default_rng(seed).standard_normal((2, 57, 80)).astype(np.float32)
    ref = np.asarray(jm.apply(params, jnp.asarray(feats)))
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    assert got.shape == ref.shape == (2, SMALL["lin_neurons"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * np.abs(ref).max())


@pytest.mark.parametrize("fc_bias", [True, False])
def test_embedder_from_a_speechbrain_checkpoint(tmp_path, fc_bias):
    _, params = jax_params(2)
    ckpt = write_checkpoint(tmp_path / "embedding_model.ckpt", params, fc_bias)
    ours, ref = TE.make_ecapa_embedder(ckpt, device="cpu"), JE.make_ecapa_embedder(ckpt)
    assert ours.model.asp.tdnn.conv.conv.weight.shape == (8, 3 * 3 * 32, 1)
    for wav, sr in ((_audio(1.3, 3), SR), (_audio(1.0, 4, sr=8000), 8000)):
        got, want = ours(wav, sr), ref(wav, sr)
        assert got.shape == want.shape == (SMALL["lin_neurons"],)
        assert np.linalg.norm(got) == pytest.approx(1.0, abs=1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
        assert float(np.dot(got, want)) >= 1 - 1e-6
