"""Each LSTM and GRU model's bf16 distance from the JAX package's bf16, on
the CPU: the served output's rel-L2, port bf16 against JAX bf16, from the
same seeded weights at the tests' small widths (the readings of
tests/test_torch_bf16_sep.py, tests/test_torch_bf16_enh.py and
tests/test_torch_variants.py). Prints one JSON line per model.

    python tests/bf16_rnn_distance.py [name ...]
    python tests/bf16_rnn_distance.py --first-lstm [name ...]

With ``--first-lstm``, the layer instead of the model, for the separation
models: the first LSTM the bf16 forward runs (its forward direction), port
against JAX, in the model (each package's own input) and alone (the port's
layer on the input the JAX layer read, the same weights and initial
state), and the distance between the two inputs.

Run from the repository root; it takes a few minutes (the JAX compiles).
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

# The recurrent models: separation by model name, enhancement by config
# stem, the variants by their test id.
SEPARATION = ("DPRNNTasNet", "DPTNetModel", "BSRNN", "TFGridNet", "SkiMNet")
ENHANCEMENT = ("fullband", "fullsubnet", "fastfullsubnet", "fullsubnet_plus", "inter_subnet",
               "dccrn", "bsrnn_espnet")
VARIANTS = ("inter_subnet-gru", "fullband-gru", "fullsubnet-gru", "fastfullsubnet-gru",
            "fullsubnet_plus-gru", "dccrn-lstm")


def first_lstm(name: str) -> dict:
    """The first LSTM of ``name``'s bf16 forward, port against JAX: rel-L2
    of its inputs, of its forward direction's output in the model, and of
    that output with the port's layer fed the JAX layer's input."""
    import flax.linen as nn
    import jax.numpy as jnp
    import numpy as np
    import test_torch_bf16_sep as sep

    from sonicsim_tpu.infer.precision import cast_floating
    from sonicsim_tpu_torch.infer.precision import bf16_call, cast_state
    from sonicsim_tpu_torch.models import zoo_layers

    r = sep.readings(name)
    calls = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.RNN) and context.method_name == "__call__" \
                and not calls:
            calls.append((args[0], out[1] if kwargs.get("return_carry") else out))
        return out

    with nn.intercept_methods(interceptor):
        r.jm.apply(cast_floating(r.params), jnp.asarray(r.mix).astype(jnp.bfloat16))
    j_in, j_out = (torch.from_numpy(np.array(a, np.float32)) for a in calls[0])
    hidden = j_out.shape[-1]

    def port_first(feed=None):
        seen, run = [], zoo_layers.LSTMLayer.run

        def first(self, x, hx=None):
            if not seen and feed is not None:
                x = feed.to(x.dtype)
            out = run(self, x, hx)
            if not seen:
                seen.append((x.float(), out[0][..., :hidden].float()))
            return out

        zoo_layers.LSTMLayer.run = first
        try:
            with torch.inference_mode():
                bf16_call(r.model, cast_state(r.model), torch.from_numpy(r.mix))
        finally:
            zoo_layers.LSTMLayer.run = run
        return seen[0]

    t_in, t_out = port_first()
    _, alone = port_first(j_in)
    return {"model": name, "input_shape": list(j_in.shape), "hidden": hidden,
            "input_port_vs_jax": sep.rel_l2(t_in.numpy(), j_in.numpy()),
            "in_model_port_vs_jax": sep.rel_l2(t_out.numpy(), j_out.numpy()),
            "alone_port_vs_jax": sep.rel_l2(alone.numpy(), j_out.numpy())}


def main(wanted) -> None:
    if "--first-lstm" in wanted:
        torch.set_num_threads(1)
        for name in sorted(wanted - {"--first-lstm"}) or ("DPRNNTasNet", "DPTNetModel",
                                                          "SkiMNet"):
            print(json.dumps(first_lstm(name)), flush=True)
        return
    import test_torch_bf16_enh as enh
    import test_torch_bf16_sep as sep
    import test_torch_variants as var

    torch.set_num_threads(1)
    for module, names in ((sep, SEPARATION), (enh, ENHANCEMENT), (var, VARIANTS)):
        for name in names:
            if wanted and name not in wanted:
                continue
            j32, j16, t32, t16 = module.readings(name).served()
            print(json.dumps({"model": name, "port_bf16_vs_jax_bf16": sep.rel_l2(t16, j16),
                              "jax_bf16_vs_jax_f32": sep.rel_l2(j16, j32),
                              "port_bf16_vs_port_f32": sep.rel_l2(t16, t32)}), flush=True)


if __name__ == "__main__":
    main(set(sys.argv[1:]))
