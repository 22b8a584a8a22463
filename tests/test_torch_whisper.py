"""Whisper in the port against the JAX package, on the CPU, with the same
seeded weights (``chip_smoke.seeded_flax`` over the JAX init's shapes,
carried across by ``bridge.whisper_from_flax``) at a tiny width: the front
end (``mel_filters``, ``log_mel``), the forward's logits, ``greedy_decode``
and ``beam_decode`` token for token, ``sample_decode``'s contract,
``load_whisper`` from an HF directory (pytorch_model.bin and
model.safetensors), an OpenAI ``.pt`` and a bare state dict,
``ByteBpeDecoder``, the transcriber on multi-window audio (greedy and beam)
and ``make_whisper_asr``'s dispatch.

Tolerances: the mel bank equal (numpy copies); ``log_mel`` within 1e-5 of
its values, which lie in [-1, 2.5] (float32 FFTs summed in another order;
measured below 2e-6); logits within 1e-5 · max|ref| (float32 matmuls in
another order); tokens equal, each free step's top-2 logit gap checked to
exceed 1e-4 · max|logit| on the JAX side first, so that no rounding can
swap them; beam scores within 1e-5; the loaded models' logits within
1e-5 · max|ref| of JAX's ``load_whisper`` of the same file.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sonicsim_tpu.models.whisper as JW
from sonicsim_tpu.metrics import make_whisper_asr as j_make_whisper_asr
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch.metrics import make_whisper_asr
from sonicsim_tpu_torch.models import whisper as TW
from torch_threads import one_intra_op_thread  # noqa: F401

SR = 16000
REL = 1e-5
GAP_REL = 1e-4
CFG = TW.WhisperConfig(vocab_size=64, n_mels=8, d_model=16, encoder_layers=2,
                       decoder_layers=2, heads=2, ffn=32, max_source_positions=40,
                       max_target_positions=24)
SOT, EOT = np.asarray([1, 4]), 2


def _jcfg(cfg=CFG):
    return JW.WhisperConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})


def jax_params(seed=0, cfg=CFG):
    """The JAX Whisper's tree (``jax.eval_shape`` of its init) filled by
    chip_smoke.py's seeded draw; the token table scaled up 10× so that the
    tiny model's logits spread over a few units."""
    model = JW.Whisper(_jcfg(cfg))
    mel = jnp.zeros((1, cfg.n_mels, 2 * cfg.max_source_positions))
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), mel, jnp.zeros((1, 3), jnp.int32))
    params = chip_smoke.seeded_flax(tree["params"], seed)
    params["embed_tokens"]["embedding"] = 10 * params["embed_tokens"]["embedding"]
    return model, {"params": params}


def port_model(params, cfg=CFG):
    model = TW.Whisper(cfg, device="cpu")
    model.load_state_dict(bridge.whisper_from_flax(params))
    return model.eval()


def _mel(seed, b=1, cfg=CFG):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.n_mels, 2 * cfg.max_source_positions)).astype(np.float32)


def test_mel_filters_and_log_mel():
    for n_mels in (80, 128):
        np.testing.assert_array_equal(TW.mel_filters(n_mels), JW.mel_filters(n_mels))
    rng = np.random.default_rng(0)
    wav = (0.1 * rng.standard_normal((2, SR))).astype(np.float32)
    wav[1, :4000] = 0  # a stretch at the floor
    got = TW.log_mel(torch.from_numpy(wav)).numpy()
    ref = np.asarray(JW.log_mel(jnp.asarray(wav)))
    assert got.shape == ref.shape == (2, 80, SR // TW.HOP)
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL)
    one = TW.log_mel(torch.from_numpy(wav[0])).numpy()
    np.testing.assert_array_equal(one, got[:1])
    np.testing.assert_array_equal(TW.pad_or_trim(wav[0], 100), JW.pad_or_trim(wav[0], 100))
    np.testing.assert_array_equal(TW.pad_or_trim(wav[0][:50], 100),
                                  JW.pad_or_trim(wav[0][:50], 100))


def test_forward_logits_and_cache_steps():
    jm, params = jax_params(0)
    model = port_model(params)
    mel = _mel(1, b=2)
    tokens = np.random.default_rng(2).integers(0, CFG.vocab_size, (2, 7))
    ref = np.asarray(jm.apply(params, jnp.asarray(mel), jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(mel), torch.from_numpy(tokens)).numpy()
        enc = model.encode(torch.from_numpy(mel))
        self_kv, cross_kv = model.init_cache(enc, CFG.max_target_positions)
        steps = [model.decode_step(torch.from_numpy(tokens[:, p]), p, self_kv, cross_kv)[0]
                 for p in range(tokens.shape[1])]
    assert got.shape == ref.shape == (2, 7, CFG.vocab_size)
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * np.abs(ref).max())
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), got, rtol=0,
                               atol=REL * np.abs(ref).max())
    np.testing.assert_array_equal(TW.sinusoids(40, 16), JW.sinusoids(40, 16))


def _free_gaps(params, mel, tokens):
    """The JAX model's top-2 logit gap at each free step of ``tokens``
    (teacher-forced), as a share of max|logit|."""
    jm = JW.Whisper(_jcfg())
    logits = np.asarray(jm.apply(params, jnp.asarray(mel), jnp.asarray(tokens)))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return ((top2[..., 1] - top2[..., 0]) / np.abs(logits).max())[:, len(SOT) - 1:-1]


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_decode_matches_jax(seed):
    jm, params = jax_params(seed)
    model = port_model(params)
    mel = _mel(10 + seed, b=2)
    suppress = np.zeros(CFG.vocab_size, bool)
    suppress[[0, 3, 5]] = True
    ref = np.asarray(JW.greedy_decode(jm, params, jnp.asarray(mel), SOT, EOT, 16, suppress))
    got = TW.greedy_decode(model, torch.from_numpy(mel), SOT, EOT, 16, suppress).numpy()
    assert _free_gaps(params, mel, ref).min() > GAP_REL
    np.testing.assert_array_equal(got, ref)
    assert not np.isin(got[:, len(SOT):], [0, 3, 5]).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_decode_matches_jax(seed):
    jm, params = jax_params(seed)
    model = port_model(params)
    mel = _mel(20 + seed)
    suppress = np.zeros(CFG.vocab_size, bool)
    suppress[[0, 3]] = True
    ref_seq, ref_sc = JW.beam_decode(jm, params, jnp.asarray(mel), SOT, EOT, 3, 14, suppress)
    seq, sc = TW.beam_decode(model, torch.from_numpy(mel), SOT, EOT, 3, 14, suppress)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(ref_seq))
    np.testing.assert_allclose(sc.numpy(), np.asarray(ref_sc), rtol=0, atol=REL)


def test_beam_ties_go_to_the_lower_index():
    x = torch.tensor([0.5, 2.0, 2.0, -1.0, 2.0, 0.5])
    vals, idx = TW._top_k(x, 4)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


def test_sample_decode_contract():
    """As tests/test_whisper.py states it: near-zero temperature is greedy;
    ``avg_logprob`` is the mean of the model's own full-forward log-probs
    of the sampled tokens (eot included); a seeded generator repeats."""
    _, params = jax_params(3)
    model = port_model(params)
    mel = torch.from_numpy(_mel(30, b=2))
    suppress = np.zeros(CFG.vocab_size, bool)
    suppress[[0, 3]] = True

    def sample(temp, seed):
        gen = torch.Generator().manual_seed(seed)
        return TW.sample_decode(model, mel, SOT, EOT, gen, temp, 16, suppress)

    greedy = TW.greedy_decode(model, mel, SOT, EOT, 16, suppress)
    np.testing.assert_array_equal(sample(1e-9, 0)[0].numpy(), greedy.numpy())
    toks, lp = sample(1.0, 5)
    toks2, lp2 = sample(1.0, 5)
    np.testing.assert_array_equal(toks.numpy(), toks2.numpy())
    np.testing.assert_array_equal(lp.numpy(), lp2.numpy())
    assert bool((toks < CFG.vocab_size).all()) and bool(torch.isfinite(lp).all())
    with torch.no_grad():
        logits = model(mel, toks).masked_fill(torch.from_numpy(suppress), -torch.inf)
    logp = torch.log_softmax(logits, -1)
    for b in range(2):
        gen = toks[b, len(SOT):]
        n = int((gen == EOT).nonzero()[0]) + 1 if bool((gen == EOT).any()) else len(gen)
        want = logp[b, len(SOT) - 1:len(SOT) - 1 + n].gather(
            1, gen[:n, None])[:, 0].mean()
        assert float(lp[b]) == pytest.approx(float(want), abs=1e-5)


def _hf_state_dict(params) -> dict:
    """The port's state dict under HF's WhisperForConditionalGeneration
    names (``model.`` prefix, the tied ``proj_out``)."""
    sd = {f"model.{k}": v for k, v in bridge.whisper_from_flax(params).items()}
    sd["proj_out.weight"] = sd["model.decoder.embed_tokens.weight"]
    return sd


def _openai_state_dict(params) -> dict:
    sd = {}
    for k, v in bridge.whisper_from_flax(params).items():
        for old, new in reversed(TW._OPENAI_RENAMES):
            k = k.replace(new, old)
        k = (k.replace("encoder.layer_norm", "encoder.ln_post")
             .replace("decoder.layer_norm.", "decoder.ln.")
             .replace("decoder.embed_tokens", "decoder.token_embedding")
             .replace("embed_positions.weight", "positional_embedding"))
        sd[k] = v.half()  # the released .pt files are float16
    return sd


def _fake_vocab():
    # GPT-2-style byte-level tokens enough to spell "hello world" (as
    # tests/test_whisper.py's).
    vocab = {"<|endoftext|>": 2, "<|startoftranscript|>": 1, "<|notimestamps|>": 4}
    for i, tok in enumerate(["hello", "Ġworld", "Ġ", "h", "é"]):
        vocab[tok] = 10 + i
    return vocab


def write_hf_dir(path, params, heads=CFG.heads, safetensors=False):
    """An HF checkpoint directory of ``params``: config.json, the weights
    and vocab.json."""
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps({"decoder_attention_heads": heads}))
    sd = _hf_state_dict(params)
    if safetensors:
        from safetensors.torch import save_file

        save_file({k: v.clone() for k, v in sd.items()}, str(path / "model.safetensors"))
    else:
        torch.save(sd, path / "pytorch_model.bin")
    (path / "vocab.json").write_text(json.dumps(_fake_vocab()))
    return path


@pytest.mark.parametrize("fmt", ["hf", "safetensors", "openai", "bare"])
def test_load_whisper_formats(tmp_path, fmt):
    _, params = jax_params(4)
    if fmt in ("hf", "safetensors"):
        path = write_hf_dir(tmp_path / "ckpt", params, safetensors=fmt == "safetensors")
    elif fmt == "openai":
        path = tmp_path / "tiny.pt"
        torch.save({"dims": {"n_audio_head": CFG.heads},
                    "model_state_dict": _openai_state_dict(params)}, path)
    else:
        path = tmp_path / "bare.pt"
        torch.save(bridge.whisper_from_flax(params), path)
    cfg, model, model_dir = TW.load_whisper(path, device="cpu")
    j_cfg, j_params, j_dir = JW.load_whisper(path)
    assert cfg == TW.WhisperConfig(**vars(j_cfg)) and model_dir == j_dir
    # A bare state dict carries no head count: d_model // 64, as released.
    assert cfg.heads == (1 if fmt == "bare" else CFG.heads)
    mel, tokens = _mel(40), np.asarray([[1, 4, 10, 11]])
    ref = np.asarray(JW.Whisper(j_cfg).apply(j_params, jnp.asarray(mel), jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(mel), torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * np.abs(ref).max())


def test_byte_bpe_decoder(tmp_path):
    ours, ref = TW.ByteBpeDecoder(_fake_vocab()), JW.ByteBpeDecoder(_fake_vocab())
    ids = [1, 4, 10, 11, 12, 13, 14, 2, 99]
    # "é" is a lone byte 0xE9 in GPT-2's byte map: not UTF-8, so replaced.
    assert ours.decode(ids) == ref.decode(ids) == "hello world h\ufffd"
    assert ours.sot_sequence() == ref.sot_sequence() == [1, 4]
    assert ours.eot() == ref.eot() == 2
    np.testing.assert_array_equal(ours.suppress_mask(), ref.suppress_mask())
    released = {"<|endoftext|>": 50256, "<|startoftranscript|>": 50257, "<|en|>": 50258,
                "<|transcribe|>": 50358, "<|notimestamps|>": 50362}
    assert TW.ByteBpeDecoder(released).sot_sequence() == [50257, 50362]
    multi = dict(released, **{"<|startoftranscript|>": 50258, "<|en|>": 50259})
    assert (TW.ByteBpeDecoder(multi).sot_sequence()
            == JW.ByteBpeDecoder(multi).sot_sequence() == [50258, 50259, 50358, 50362])
    (tmp_path / "vocab.json").write_text(json.dumps(_fake_vocab()))
    (tmp_path / "added_tokens.json").write_text(json.dumps({"<|x|>": 20}))
    assert 20 in TW.ByteBpeDecoder.from_dir(tmp_path).specials
    for text in ("", "abc", "la " * 40):
        assert TW._compression_ratio(text) == JW._compression_ratio(text)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    _, params = jax_params(5)
    return write_hf_dir(tmp_path_factory.mktemp("whisper") / "tiny", params)


def test_transcriber_greedy_and_beam_on_long_audio(hf_dir):
    """Three windows (the tiny model's window is 2·40·160 samples), greedy
    and beam, equal to the JAX transcriber's text; the fallback chain runs
    its temperatures where the thresholds cannot be met."""
    audio = (0.05 * np.random.default_rng(6).standard_normal(30000)).astype(np.float32)
    for kwargs in (dict(max_new_tokens=8), dict(max_new_tokens=8, beam_size=3,
                                                temperatures=(0.0,))):
        fn = TW.make_whisper_transcriber(hf_dir, device="cpu", **kwargs)
        ref = JW.make_whisper_transcriber(hf_dir, **kwargs)
        assert fn(audio, SR) == ref(audio, SR)
        assert fn.stats["windows"] == fn.stats["decodes"] == 3
    fallback = TW.make_whisper_transcriber(hf_dir, max_new_tokens=6, beam_size=2,
                                           log_prob_threshold=0.0, temperatures=(0.0, 0.5, 1.0),
                                           device="cpu")
    assert isinstance(fallback(audio[:12800], SR), str)
    assert fallback.stats["windows"] == 1 and fallback.stats["decodes"] == 3
    assert isinstance(fallback(audio[:4000], 8000), str)  # resampled to 16 kHz


def test_make_whisper_asr_dispatch(hf_dir):
    """A local checkpoint transcribes through the port; a model name goes to
    faster-whisper, which is not installed here: the JAX function's
    ImportError."""
    fn = make_whisper_asr(str(hf_dir), device="cpu")
    audio = (0.05 * np.random.default_rng(7).standard_normal(8000)).astype(np.float32)
    assert fn(audio, SR) == j_make_whisper_asr(str(hf_dir))(audio, SR)
    with pytest.raises(ImportError) as ours:
        make_whisper_asr("medium.en")
    with pytest.raises(ImportError) as ref:
        j_make_whisper_asr("medium.en")
    assert "faster-whisper is not importable" in str(ours.value)
    assert "faster-whisper is not importable" in str(ref.value)
