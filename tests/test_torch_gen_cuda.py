"""One short SonicSet mixture generated on the card, held against the same
mixture generated by the port on the CPU.

Tolerance: 4e-5 · max|ref| on float32 tracks (tests/test_torch_slice.py's
``SLICE_REL`` for tracks through rendered banks); the plan and metadata are
equal. The mixture step must launch K1 in its ramp form.

These tests import neither jax nor the JAX package and use no conftest
fixture, so they run on the card alone:
``python -m pytest --noconftest -m cuda tests/test_torch_gen_cuda.py``.
"""

import json

import numpy as np
import pytest
import torch

from sonicsim_tpu_torch.dataset import generate_split, scan_audio_lengths
from sonicsim_tpu_torch.ops import kernels
from sonicsim_tpu_torch.sim import Scene
from sonicsim_tpu_torch.utils import read_wav, write_wav

SR = 16000
SLICE_REL = 4e-5
TRACKS = [f"moving_audio_{i}.wav" for i in (1, 2, 3)] + ["noise_audio.wav", "music_audio.wav"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: generation's card path runs only there")
    return torch.device("cuda")


def _corpus(root, n, seconds, rng, prefix):
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        t = np.arange(int(seconds * SR)) / SR
        x = (0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t)
             * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
        x += 0.01 * rng.standard_normal(len(x)).astype(np.float32)
        write_wav(root / f"{prefix}{i}.wav", x, SR)
    return scan_audio_lengths(root)


@pytest.mark.cuda
def test_generated_mixture_on_card_matches_cpu(tmp_path, cuda_device):
    rng = np.random.default_rng(0)
    dirs = []
    for i in range(3):
        _corpus(tmp_path / "speech" / f"spk{i}", 3, 2.0, rng, f"u{i}_")
        dirs.append(str(tmp_path / "speech" / f"spk{i}"))
    noise = _corpus(tmp_path / "noise", 2, 3.0, rng, "n")
    music = _corpus(tmp_path / "music", 2, 5.0, rng, "m")
    outs = {}
    for device in ("cpu", None):
        def factory(name, device=device):
            return Scene.synthetic(room=name, dims=(9.0, 3.0, 7.0), channel_type="Binaural",
                                   seed=2, max_order=2, n_bands=32, device=device)

        kernels.reset_launch_counts()
        (outs[device],) = generate_split(factory, ["roomA"], dirs, noise, music,
                                         tmp_path / f"set_{device}", duration=6.0,
                                         wav_encoding="float32")
        launches = dict(kernels.LAUNCHES)
    assert launches["select_segments_ramp"] > 0
    cpu, card = outs["cpu"], outs[None]
    for name in ("mixture_plan.json", "json_data.json"):
        assert (card / name).read_bytes() == (cpu / name).read_bytes()
    assert "pcm16_peak_scale" not in json.loads((card / "json_data.json").read_text())
    for name in TRACKS:
        got, _ = read_wav(card / name)
        ref, _ = read_wav(cpu / name)
        assert got.shape == ref.shape == (2, 6 * SR) and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=0, atol=SLICE_REL * np.abs(ref).max())
