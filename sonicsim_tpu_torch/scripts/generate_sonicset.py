"""SonicSet generation from the command line, on the card or the CPU.

Example:
  python -m sonicsim_tpu_torch.scripts.generate_sonicset --mode train \\
      --results_root SonicSet --speech_root /data/librispeech_speakers \\
      --noise_json data/train_noise.json --music_json data/train_music.json \\
      --channel_type Binaural [--device cpu]

Without real Matterport banks, scenes are synthetic shoeboxes whose
dimensions are derived deterministically from the scene name; with
``--bank_dir``, scenes load precomputed RIR banks instead. ``--device``
names where scenes run (default: the card; ``cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from ..dataset.generate import generate_split
from ..dataset.plan import load_length_manifest, scan_audio_lengths
from ..sim import CIRCULAR_4CH_ARRAY, LINEAR_4CH_ARRAY, Scene
from ..utils.seeding import stable_seed


def synthetic_scene_factory(
    channel_type, channel_order, mic_array, seed, n_bands: int = 32,
    device=None,
):
    """``factory(name) -> Scene``: a shoebox whose dimensions and absorption
    are drawn from ``stable_seed(name, seed)``, with 32-band
    frequency-dependent walls (the reference's acoustic config) and the
    batched bank renderer, on ``device``."""
    def factory(name: str) -> Scene:
        rng = np.random.default_rng(stable_seed(name, seed))
        dims = (
            float(rng.uniform(7.0, 16.0)),
            float(rng.uniform(2.6, 4.0)),
            float(rng.uniform(6.0, 14.0)),
        )
        return Scene.synthetic(
            room=name,
            dims=dims,
            absorption=float(rng.uniform(0.15, 0.45)),
            channel_type=channel_type,
            channel_order=channel_order,
            mic_array=mic_array,
            seed=seed,
            n_bands=n_bands,
            device=device,
        )

    return factory


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="train", choices=["train", "val", "test"])
    ap.add_argument("--results_root", default="SonicSet")
    ap.add_argument("--scene_list", default=None, help="file with scene names")
    ap.add_argument("--n_scenes", type=int, default=2)
    ap.add_argument("--speech_root", required=True,
                    help="directory of per-speaker folders")
    ap.add_argument("--noise_json", default=None)
    ap.add_argument("--noise_dir", default=None)
    ap.add_argument("--music_json", default=None)
    ap.add_argument("--music_dir", default=None)
    ap.add_argument("--channel_type", default="Binaural",
                    choices=["Mono", "Binaural", "Ambisonics", "CustomArrayIR"])
    ap.add_argument("--mic_array", default=None,
                    choices=[None, "linear4", "circular4"])
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max_mixtures", type=int, default=None)
    ap.add_argument("--transcripts_csv", default=None)
    ap.add_argument("--bank_dir", default=None,
                    help="directory of per-scene RIR bank .npz files; scenes "
                    "render from the banks instead of synthetic shoeboxes")
    ap.add_argument("--wav_encoding", default="pcm16",
                    choices=["pcm16", "float32"],
                    help="pcm16: half-size files, peak-guarded (scales in "
                    "json_data.json); float32: the reference's format")
    ap.add_argument("--no_utterance_cache", action="store_true",
                    help="assemble dry tracks on the host instead of from "
                    "the utterance cache on the device (output is "
                    "bit-identical either way)")
    ap.add_argument("--no_save_bank", action="store_true",
                    help="skip the per-mixture rir_bank_*.npz artifact")
    ap.add_argument("--device", default=None,
                    help="where scenes run (default: the card; 'cpu' for "
                    "the CPU)")
    args = ap.parse_args(argv)
    # Surface the per-mixture elapsed log (SonicSet_train.py:215 parity).
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )

    if args.scene_list:
        with open(args.scene_list) as f:
            scenes = [line.strip() for line in f if line.strip()]
    elif args.bank_dir:
        scenes = sorted(p.stem for p in Path(args.bank_dir).glob("*.npz"))
        if not scenes:
            ap.error(f"--bank_dir {args.bank_dir} contains no .npz banks")
    else:
        scenes = [f"scene{i:03d}" for i in range(args.n_scenes)]

    if not (args.noise_json or args.noise_dir):
        ap.error("one of --noise_json / --noise_dir is required")
    if not (args.music_json or args.music_dir):
        ap.error("one of --music_json / --music_dir is required")
    speech_dirs = sorted(
        str(p) for p in Path(args.speech_root).iterdir() if p.is_dir()
    )
    noise = (
        load_length_manifest(args.noise_json)
        if args.noise_json
        else scan_audio_lengths(args.noise_dir)
    )
    music = (
        load_length_manifest(args.music_json)
        if args.music_json
        else scan_audio_lengths(args.music_dir)
    )
    transcripts = None
    if args.transcripts_csv:
        from ..utils.transcripts import load_transcripts

        transcripts = load_transcripts(args.transcripts_csv)

    mic_array = {
        None: None, "linear4": LINEAR_4CH_ARRAY, "circular4": CIRCULAR_4CH_ARRAY
    }[args.mic_array]
    if args.bank_dir:
        bank_dir = Path(args.bank_dir)

        def factory(name: str) -> Scene:
            return Scene.from_bank(
                bank_dir / f"{name}.npz", room=name,
                channel_type=args.channel_type, mic_array=mic_array,
                device=args.device,
            )
    else:
        factory = synthetic_scene_factory(
            args.channel_type, 1, mic_array, args.seed, device=args.device
        )
    produced = generate_split(
        factory,
        scenes,
        speech_dirs,
        noise,
        music,
        Path(args.results_root) / args.mode,
        transcripts=transcripts,
        duration=args.duration,
        base_seed=args.seed,
        max_mixtures=args.max_mixtures,
        wav_encoding=args.wav_encoding,
        utterance_cache=not args.no_utterance_cache,
        save_bank=not args.no_save_bank,
    )
    print(f"generated {len(produced)} mixtures under {args.results_root}/{args.mode}")


if __name__ == "__main__":
    main()
