"""SonicSim in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``sonicsim_tpu`` (JAX/XLA/Pallas), which stays the reference it
is held against. This package imports neither jax nor ``sonicsim_tpu``.
Ported so far: the moving-source render, the per-mixture render step of
SonicSet generation, and the RIR-bank render.

* ``ops`` — trajectory plans, FFT convolutions, BS.1770 loudness, levels,
  and the two Hopper kernels (``ops.kernels``, sources in ``csrc/``).
* ``parallel`` — ``render_mixture_sources``, one device.
* ``sim`` — rooms, channels, materials, RIR oracles and the batched
  RIR-bank renderer.
* ``bridge`` — RIR banks, room descriptions and numpy state into the port.
"""

from . import bridge, ops, parallel, sim
from .bridge import load_rir_bank, to_torch
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from .parallel import pad_moving_plans, render_mixture_sources

__all__ = [
    "bridge",
    "load_rir_bank",
    "ops",
    "pad_moving_plans",
    "parallel",
    "render_mixture_sources",
    "sim",
    "to_torch",
    *_ops_all,
]
