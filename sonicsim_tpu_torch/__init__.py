"""SonicSim in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``sonicsim_tpu`` (JAX/XLA/Pallas), which stays the reference it
is held against. This package imports neither jax nor ``sonicsim_tpu``.
Ported so far: the moving-source render, the RIR-bank render, SonicSet
generation end to end, and ConvTasNet serving, evaluation and training.

* ``ops`` — trajectory plans, FFT convolutions, BS.1770 loudness, levels,
  and the two Hopper kernels (``ops.kernels``, sources in ``csrc/``).
* ``parallel`` — ``render_mixture_sources``, one device.
* ``sim`` — rooms, channels, materials, RIR oracles, the batched
  RIR-bank renderer, navigable space and scenes.
* ``dataset`` — SonicSet generation: plans, dry-track assembly, the
  per-mixture render and ``generate_split``; the training and eval
  samplers that read generated splits, the prefetching loader and
  ``MovingDataModule``.
* ``models`` — ConvTasNet, the registry and checkpoints in the JAX
  package's pack format (``from_pretrain``, ``save_model``).
* ``infer`` — bf16 inference, segment stitching, the energy VAD.
* ``losses`` and ``metrics`` — SI-SDR/SNR, PIT, BSS SDR, STOI, PESQ and
  the ``MetricsTracker``.
* ``train`` — the LR controllers, the optax-exact train step (fp32, bf16)
  and the one-device ``Trainer``.
* ``utils`` — WAV I/O, seeding, audio helpers, transcripts, YAML configs.
* ``scripts`` — ``python -m sonicsim_tpu_torch.scripts.<name>`` for
  ``generate_sonicset``, ``train``, ``inference``, ``audio_test``, ``test``
  and ``generate_fixed_eval``.
* ``bridge`` — RIR banks, room and scene descriptions, mixture plans, model
  weights and numpy state into the port.
"""

__version__ = "0.2.0"

from . import bridge, dataset, infer, losses, metrics, models, ops, parallel, sim, train, utils
from .bridge import load_rir_bank, to_torch
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from .parallel import pad_moving_plans, render_mixture_sources

__all__ = [
    "bridge",
    "dataset",
    "infer",
    "load_rir_bank",
    "losses",
    "metrics",
    "models",
    "ops",
    "pad_moving_plans",
    "parallel",
    "render_mixture_sources",
    "sim",
    "to_torch",
    "train",
    "utils",
    *_ops_all,
]
