"""One mixture through ``render_mixture`` of both packages on the CPU, from
the same plan and corpus: a flat Mono room (``n_bands=0``, the serial RIR
renderer) and an 8-band Binaural room (the batched bank renderer).

Tolerances:
- float32 WAVs: 4e-5 · max|ref| (tests/test_torch_slice.py's ``SLICE_REL``
  for tracks through banks that each package renders itself);
- pcm16 WAVs: 2 codes (the same track difference, quantised);
- json_data.json equal, apart from ``pcm16_peak_scale`` within rtol 1e-4;
- mixture_plan.json byte-equal;
- the float16 bank: the bank bound (5e-5 · peak, rtol 1e-4 for the batched
  renderer; 1e-5 · peak for the serial one) plus one float16 step (2^-10
  relative).
"""

import dataclasses
import json

import numpy as np
import pytest

from sonicsim_tpu.dataset.generate import plan_mixture as j_plan_mixture
from sonicsim_tpu.dataset.generate import render_mixture as j_render_mixture
from sonicsim_tpu.sim.scene import Scene as JScene
from sonicsim_tpu.utils.wavio import read_wav as j_read_wav
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch.dataset import (
    UtteranceCache,
    plan_mixture,
    render_mixture,
    scan_audio_lengths,
)
from sonicsim_tpu_torch.utils import read_wav, write_wav
from torch_threads import one_intra_op_thread  # noqa: F401

SR = 16000
SLICE_REL = 4e-5
PCM_CODES = 2
SCALE_RTOL = 1e-4
F16_RTOL = 2.0**-10
TRACKS = [f"moving_audio_{i}.wav" for i in (1, 2, 3)] + ["noise_audio.wav", "music_audio.wav"]


def _corpus(root, n, seconds, rng, prefix):
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        t = np.arange(int(seconds * SR)) / SR
        x = (0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t)
             * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
        x += 0.01 * rng.standard_normal(len(x)).astype(np.float32)
        write_wav(root / f"{prefix}{i}.wav", x, SR)
    return scan_audio_lengths(root)


@pytest.mark.parametrize("n_bands,channel,bank_atol,bank_rtol",
                         [(0, "Mono", 1e-5, 0.0), (8, "Binaural", 5e-5, 1e-4)],
                         ids=["flat-mono", "8band-binaural"])
def test_render_mixture_matches_reference(tmp_path, n_bands, channel, bank_atol, bank_rtol):
    rng = np.random.default_rng(20 + n_bands)
    speech = [_corpus(tmp_path / f"spk{i}", 3, 1.2, rng, f"s{i}_") for i in range(3)]
    noise = _corpus(tmp_path / "noise", 2, 1.5, rng, "n")
    music = _corpus(tmp_path / "music", 2, 1.5, rng, "m")
    ref_scene = JScene.synthetic(room="roomC", dims=(8.0, 3.0, 6.0), channel_type=channel,
                                 seed=4, max_order=2, n_bands=n_bands)
    scene = bridge.scene_from_fields(dataclasses.asdict(ref_scene), device="cpu")
    kw = dict(duration=4.0, seed=9, max_silence_seconds=1.0)
    ref_plan = j_plan_mixture(ref_scene, speech, noise, music, np.random.default_rng(9), **kw)
    plan = plan_mixture(scene, speech, noise, music, np.random.default_rng(9), **kw)
    words = {f"s{i}_{j}.flac": f"w{i}{j}" for i in range(3) for j in range(3)}

    outs = {}
    for enc in ("float32", "pcm16"):
        # The port assembles dry tracks from its device cache for one
        # encoding and on the host for the other; both are bit-identical.
        cache = UtteranceCache(sample_rate=SR, device="cpu") if enc == "pcm16" else None
        t_out, j_out = tmp_path / f"port_{enc}", tmp_path / f"jax_{enc}"
        meta = render_mixture(scene, plan, t_out, transcripts=words, wav_encoding=enc,
                              cache=cache)
        ref_meta = j_render_mixture(ref_scene, ref_plan, j_out, transcripts=words,
                                    wav_encoding=enc)
        assert sorted(p.name for p in t_out.iterdir()) == sorted(p.name for p in j_out.iterdir())
        assert (t_out / "mixture_plan.json").read_bytes() == \
            (j_out / "mixture_plan.json").read_bytes()
        saved = json.loads((t_out / "json_data.json").read_text())
        ref_saved = json.loads((j_out / "json_data.json").read_text())
        assert saved == json.loads(json.dumps(meta))
        scales, ref_scales = saved.pop("pcm16_peak_scale", {}), ref_saved.pop("pcm16_peak_scale", {})
        assert saved == ref_saved and ref_meta["source1"]["words"]
        assert scales.keys() == ref_scales.keys()
        for k in scales:
            assert scales[k] == pytest.approx(ref_scales[k], rel=SCALE_RTOL)
        for name in TRACKS:
            got, sr = read_wav(t_out / name)
            ref, _ = j_read_wav(j_out / name)
            assert sr == SR and got.shape == ref.shape == (scene.channel.count, 4 * SR)
            if enc == "float32":
                np.testing.assert_allclose(got, ref, rtol=0,
                                           atol=SLICE_REL * np.abs(ref).max())
            else:
                assert np.abs(got - ref).max() * 32768 <= PCM_CODES, name
        outs[enc] = t_out
        bank = np.load(t_out / f"rir_bank_{channel}.npz")
        ref_bank = np.load(j_out / f"rir_bank_{channel}.npz")
        assert bank["rirs"].dtype == ref_bank["rirs"].dtype == np.float16
        for k in ("source_positions", "receiver_positions", "sample_rate"):
            np.testing.assert_array_equal(bank[k], ref_bank[k])
        want = ref_bank["rirs"].astype(np.float32)
        np.testing.assert_allclose(bank["rirs"].astype(np.float32), want,
                                   rtol=bank_rtol + F16_RTOL,
                                   atol=bank_atol * np.abs(want).max())
    # pcm16 is the float32 track (peak-guarded) quantised on the device.
    for name in TRACKS:
        f32, _ = read_wav(outs["float32"] / name)
        q16, _ = read_wav(outs["pcm16"] / name)
        s = scales.get(name, 1.0)
        assert np.abs(q16 / s - f32).max() < 1.0 / 32768.0 / s
