"""SonicSim in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``sonicsim_tpu`` (JAX/XLA/Pallas), which stays the reference it
is held against. This package imports neither jax nor ``sonicsim_tpu``.
Ported so far: the moving-source render, the RIR-bank render and SonicSet
generation end to end.

* ``ops`` — trajectory plans, FFT convolutions, BS.1770 loudness, levels,
  and the two Hopper kernels (``ops.kernels``, sources in ``csrc/``).
* ``parallel`` — ``render_mixture_sources``, one device.
* ``sim`` — rooms, channels, materials, RIR oracles, the batched
  RIR-bank renderer, navigable space and scenes.
* ``dataset`` — SonicSet generation: plans, dry-track assembly, the
  per-mixture render and ``generate_split``.
* ``utils`` — WAV I/O, seeding, audio helpers, transcripts.
* ``scripts`` — ``python -m sonicsim_tpu_torch.scripts.generate_sonicset``.
* ``bridge`` — RIR banks, room and scene descriptions, mixture plans and
  numpy state into the port.
"""

from . import bridge, dataset, ops, parallel, sim, utils
from .bridge import load_rir_bank, to_torch
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from .parallel import pad_moving_plans, render_mixture_sources

__all__ = [
    "bridge",
    "dataset",
    "load_rir_bank",
    "ops",
    "pad_moving_plans",
    "parallel",
    "render_mixture_sources",
    "sim",
    "to_torch",
    "utils",
    *_ops_all,
]
