"""The sidecar models on the card, held against the port on the CPU with
the same seeded weights at their published widths, as chip_smoke.py's
phase 17 holds them: Whisper medium.en (an HF directory written by
``chip_smoke.write_whisper_hf``), ECAPA-TDNN at spkrec-ecapa-voxceleb's
widths (an embedding_model.ckpt) and PyanNet at the JAX module's defaults
(a pyannote checkpoint), on seeded speech-like noise.

Tolerances: 1e-4 · max|ref| (TF32 off; cuDNN's and cuBLAS's float32 sum
in another order) for Whisper's log-mel, encoder output and teacher-forced
logits, ECAPA's embedding and PyanNet's frame probabilities; Whisper's
greedy tokens the CPU's argmax up to the first position whose CPU top-2
logit gap is under that tolerance; ECAPA's unit embeddings at cosine
≥ 1 − 1e-6; PyanNet's spans the CPU's but at frames whose probability lies
within the tolerance of the threshold.

These tests import neither jax nor the JAX package and use no conftest
fixture, so they run on the card alone:
``python -m pytest --noconftest -m cuda tests/test_torch_sidecar_models_cuda.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from sonicsim_tpu_torch.models import ecapa as E
from sonicsim_tpu_torch.models import pyannet as P
from sonicsim_tpu_torch.models import whisper as W
from sonicsim_tpu_torch.scripts.common import strict_float32

SR = 16000
CFG = chip_smoke.SIDECAR_MODELS
REL = chip_smoke.SIDECAR_REL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sidecar models' card run")
    strict_float32()
    return torch.device("cuda")


def _speechy(seconds: float, seed: int) -> np.ndarray:
    """Bursts of a gliding tone over a noise floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    gate = (np.sin(2 * np.pi * 0.4 * t) > 0).astype(np.float64)
    x = 0.3 * gate * np.sin(2 * np.pi * (150 + 50 * np.sin(2 * np.pi * 0.5 * t)) * t)
    return (x + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.mark.cuda
def test_whisper_medium_en_on_the_card(cuda_device, tmp_path):
    path = chip_smoke.write_whisper_hf(tmp_path / "whisper", CFG["whisper"], 0, cuda_device)
    _, card, _ = W.load_whisper(path, device=cuda_device)
    _, cpu, _ = W.load_whisper(path, device="cpu")
    tok = W.ByteBpeDecoder.from_dir(path)
    sup = np.pad(tok.suppress_mask(), (0, card.cfg.vocab_size - len(tok.suppress_mask())),
                 constant_values=True)
    chunk = torch.from_numpy(W.pad_or_trim(_speechy(30.0, 1)))
    hold = chip_smoke._whisper_hold(cuda_device, card, cpu, chunk, np.asarray(
        tok.sot_sequence()), tok.eot(), sup, CFG["tf_positions"])
    assert max(hold["mel"], hold["encoder"], hold["logits"]) <= REL, hold


@pytest.mark.cuda
def test_ecapa_voxceleb_widths_on_the_card(cuda_device, tmp_path):
    ckpt = chip_smoke.write_ecapa_ckpt(tmp_path / "embedding_model.ckpt", CFG["ecapa"], 0,
                                       cuda_device)
    card, cpu = E.make_ecapa_embedder(ckpt, cuda_device), E.make_ecapa_embedder(ckpt, "cpu")
    wav = _speechy(CFG["embed_s"], 2)
    x = torch.from_numpy(wav)
    with torch.inference_mode():
        got = card.model(E.ecapa_fbank(x.to(cuda_device)))[0].cpu()
        ref = cpu.model(E.ecapa_fbank(x))[0]
    assert float((got - ref).abs().max()) <= REL * float(ref.abs().max())
    assert float(np.dot(card(wav), cpu(wav))) >= 1 - 1e-6


@pytest.mark.cuda
def test_pyannet_defaults_on_the_card(cuda_device, tmp_path):
    wav = _speechy(60.0, 3)
    ckpt = chip_smoke.write_pyannet_ckpt(tmp_path / "pyannet.ckpt", CFG["pyannet"], 0, wav,
                                         cuda_device)
    card, cpu = P.make_neural_vad(ckpt, device=cuda_device), P.make_neural_vad(ckpt, device="cpu")
    with torch.inference_mode():
        got = card.model(torch.from_numpy(wav)[None].to(cuda_device))[0].amax(-1).cpu().numpy()
        ref = cpu.model(torch.from_numpy(wav)[None])[0].amax(-1).numpy()
    tol = REL * float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= tol
    assert chip_smoke.vad_spans_held(got, ref, cpu.model.frame_times(len(wav)), tol)
    assert cpu(wav, SR)
