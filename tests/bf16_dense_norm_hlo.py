"""The compiled HLO of ``jax.vjp`` of SkiM's bfloat16 ``proj`` + ``norm``
pair, on the CPU: what ``layers.dense_norm_bf16``'s backward follows.

flax's ``Dense`` on a bfloat16 input, then one of three norms, the
parameters float32 and cast to bfloat16 inside the function as
``make_train_step(precision="bf16")`` casts them:

* ``gln``: ``GroupNorm1`` (sonicsim_tpu/models/zoo_layers.py:18) alone;
* ``fused``: ``GroupNorm1`` with the residual the JAX ``SegLSTM`` adds
  (sonicsim_tpu/models/skim.py:72-73), as XLA fuses it there;
* ``cln``: the causal ``ChannelLayerNorm`` (sonicsim_tpu/models/layers.py:35)
  with the residual.

Prints each flavour's optimised HLO (``jax.jit(...).lower(...).compile()
.as_text()``) without its metadata: the dtype and order of each reduction
(a bfloat16 reduce shows as a float32 reduce whose adder rounds to
bfloat16; XLA's TreeReductionRewriter splits an axis longer than 32 into
``reduce-window``s of 32) and each rounding (a ``convert`` to bf16 and back).

    python tests/bf16_dense_norm_hlo.py [gln|fused|cln ...] [--rows N K]

Run from the repository root; a few seconds a flavour.
"""

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sonicsim_tpu.infer.precision import cast_floating  # noqa: E402
from sonicsim_tpu.models.layers import ChannelLayerNorm  # noqa: E402
from sonicsim_tpu.models.zoo_layers import GroupNorm1  # noqa: E402

FLAVOURS = ("gln", "fused", "cln")
HIDDEN, CHANNELS = 32, 16


class Pair(nn.Module):
    flavour: str

    @nn.compact
    def __call__(self, out, x):
        y = nn.Dense(CHANNELS, name="proj")(out)
        if self.flavour == "gln":
            return GroupNorm1(name="norm")(y)
        if self.flavour == "fused":
            return x + GroupNorm1(name="norm")(y)
        return x + ChannelLayerNorm(CHANNELS, name="norm")(y)


def compiled_vjp(flavour: str, n: int, k: int) -> str:
    """The optimised HLO of the pair's VJP at (n, k) rows, metadata cut."""
    model = Pair(flavour)
    rng = np.random.default_rng(0)
    out = jnp.asarray(rng.standard_normal((n, k, HIDDEN)), jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((n, k, CHANNELS)), jnp.bfloat16)
    ct = jnp.asarray(rng.standard_normal((n, k, CHANNELS)), jnp.bfloat16)
    params = model.init(jax.random.PRNGKey(0), out.astype(jnp.float32), x.astype(jnp.float32))

    def vjp(p, o, xx, c):
        return jax.vjp(lambda p, o, xx: model.apply(cast_floating(p), o, xx), p, o, xx)[1](c)

    text = jax.jit(vjp).lower(params, out, x, ct).compile().as_text()
    text = re.sub(r", metadata=\{[^}]*\}", "", text)
    keep = [line for line in text.splitlines()
            if line.strip() and not re.match(r"^(\d+ |FileNames|FunctionNames|FileLocations"
                                             r"|StackFrames)", line)]
    return "\n".join(keep)


def main(argv: list) -> None:
    rows = (3, 20)
    if "--rows" in argv:
        at = argv.index("--rows")
        rows = (int(argv[at + 1]), int(argv[at + 2]))
        argv = argv[:at] + argv[at + 3:]
    for flavour in argv or FLAVOURS:
        print(f"==== {flavour} at {rows[0]} x {rows[1]} rows ====")
        print(compiled_vjp(flavour, *rows), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
