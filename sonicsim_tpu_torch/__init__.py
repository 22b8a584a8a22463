"""SonicSim in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``sonicsim_tpu`` (JAX/XLA/Pallas), which stays the reference it
is held against. This package imports neither jax nor ``sonicsim_tpu``.
Ported so far: the moving-source render, the RIR-bank render, SonicSet
generation end to end, ConvTasNet serving, evaluation and training, the
separation zoo with SkiM's streaming, and the enhancement zoo, served and
trained, on one device or over a mesh of devices.

* ``ops`` — trajectory plans, FFT convolutions, BS.1770 loudness, levels,
  and the two Hopper kernels (``ops.kernels``, sources in ``csrc/``).
* ``parallel`` — ``render_mixture_sources`` and the device mesh (shards,
  replicas, data parallelism in one process).
* ``sim`` — rooms, channels, materials, RIR oracles, the batched
  RIR-bank renderer, navigable space and scenes.
* ``dataset`` — SonicSet generation: plans, dry-track assembly, the
  per-mixture render and ``generate_split``; the training and eval
  samplers that read generated splits, the prefetching loader and
  ``MovingDataModule``.
* ``models`` — ConvTasNet, the separation zoo (DPRNN-TasNet, SuDORMRF,
  AFRCNN, TDANet, DPTNet, BSRNN, TF-GridNet, MossFormer, MossFormer2, SkiM
  and its streamer) and the enhancement zoo (the FullSubNet family, DCCRN,
  FRCRN, BSRNN-ESPnet, the GaGNet family), with their shared
  ``zoo_layers`` and the free filterbank ``enc_dec``, the registry and
  checkpoints in the JAX package's pack format (``from_pretrain``,
  ``save_model``).
* ``infer`` — bf16 inference, segment stitching, the energy VAD.
* ``losses`` and ``metrics`` — SI-SDR/SNR, PIT, the enhancement zoo's
  losses, BSS SDR, STOI, PESQ and the ``MetricsTracker``.
* ``train`` — the LR controllers, the optax-exact train step (fp32, bf16)
  and the ``Trainer``, data-parallel over a mesh.
* ``utils`` — WAV I/O, seeding, audio helpers, transcripts, YAML configs.
* ``scripts`` — ``python -m sonicsim_tpu_torch.scripts.<name>`` for
  ``generate_sonicset``, ``train``, ``inference``, ``audio_test``, ``test``,
  ``generate_fixed_eval`` and ``stream``.
* ``bridge`` — RIR banks, room and scene descriptions, mixture plans, model
  weights and numpy state into the port.
"""

__version__ = "0.2.0"

import torch as _torch

# The first vectorised float32 math call on the CPU in a process (sqrt, exp,
# log, sin, pow) is MKL's first, which picks its code path. When that call
# runs on several OpenMP threads at once, one thread's share of the tensor
# can come out with a relative error up to 3.2e-4: 108 of 2,000 fresh
# processes on an 8-core host, 0 of 2,000 with MKL_CBWR=COMPATIBLE (MKL's
# code path pinned) and 0 of 2,000 after this single-threaded call, which
# makes every later one exact (tests/test_torch_first_call.py, ROADMAP C9).
_torch.sqrt(_torch.ones(1))

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
