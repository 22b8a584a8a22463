"""SonicSim in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``sonicsim_tpu`` (JAX/XLA/Pallas), which stays the reference it
is held against. This package imports neither jax nor ``sonicsim_tpu``.
Ported so far: the moving-source render and the per-mixture render step of
SonicSet generation.

* ``ops`` — trajectory plans, FFT convolutions, BS.1770 loudness, and the
  two Hopper kernels (``ops.kernels``, sources in ``csrc/``).
* ``parallel`` — ``render_mixture_sources``, one device.
* ``bridge`` — RIR banks and numpy state into tensors.
"""

from . import bridge, ops, parallel
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
    "to_torch",
    *_ops_all,
]
