"""Each LSTM and GRU model's bf16 distance from the JAX package's bf16, on
the CPU: the served output's rel-L2, port bf16 against JAX bf16, from the
same seeded weights at the tests' small widths (the readings of
tests/test_torch_bf16_sep.py, tests/test_torch_bf16_enh.py and
tests/test_torch_variants.py). Prints one JSON line per model.

    python tests/bf16_rnn_distance.py [name ...]
    python tests/bf16_rnn_distance.py --first-lstm [name ...]
    python tests/bf16_rnn_distance.py --trace [name ...]

With ``--first-lstm``, the layer instead of the model, for the separation
models: the first LSTM the bf16 forward runs (its forward direction), port
against JAX, in the model (each package's own input) and alone (the port's
layer on the input the JAX layer read, the same weights and initial
state), and the distance between the two inputs.

With ``--trace`` (DPTNet and SkiM by default), each separation model's
bf16 forward module by module in the port's forward order: the rel-L2 of
each port module's output from the flax module's that holds the same
tensors (the pairs of test_torch_bf16_sep.schedule_mismatches, the
innermost and the outermost of each), each side on its own input. For
DPTNet, the first attention's parts too: the q/k/v projections, the
weights, the output and the residual that ``norm_attn`` reads.

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


def _first(out):
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def _as_jax_layout(a, ref):
    """``a`` (numpy) in ``ref``'s layout: as it is, else the first axis
    order with ``ref``'s shape (channel-first against channel-last)."""
    import itertools

    if a.shape == ref.shape:
        return a
    for perm in itertools.permutations(range(a.ndim)):
        if a.transpose(perm).shape == ref.shape:
            return a.transpose(perm)
    return None


def trace(name: str) -> list:
    """``name``'s bf16 forward, port against JAX, module by module (the
    module docstring's ``--trace``): ``[(port module, flax path, rel-L2)]``
    in the port's forward order."""
    import flax.linen as nn
    import jax.numpy as jnp
    import numpy as np
    import test_torch_bf16_sep as sep

    from sonicsim_tpu.infer.precision import cast_floating
    from sonicsim_tpu_torch.infer.precision import bf16_call, cast_state
    from sonicsim_tpu_torch.models import layers

    r = sep.readings(name)

    def keep_inputs(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and args:
            context.module.sow("intermediates", "__input__", args[0])
        return next_fun(*args, **kwargs)

    def fwd(p, v):
        with nn.intercept_methods(keep_inputs):
            return r.jm.apply(cast_floating(p), v.astype(jnp.bfloat16),
                              capture_intermediates=True, mutable=["intermediates"])[1]

    inter = jax.jit(fwd)(r.params, jnp.asarray(r.mix))["intermediates"]
    j_out, j_in = {}, {}

    def walk(node, path):
        for k, v in node.items():
            if k in ("__call__", "__input__"):
                (j_out if k == "__call__" else j_in)[path] = np.asarray(_first(v), np.float32)
            elif isinstance(v, dict):
                walk(v, path + (k,))

    walk(inter, ())
    order, t_out, t_in, hooks = [], {}, {}, []

    def hook(mod, args, out, n):
        if n not in t_out:
            order.append(n)
            t_in[n], t_out[n] = (_first(a).float().numpy() for a in (args, out))

    for mod_name, m in r.model.named_modules():
        hooks.append(m.register_forward_hook(
            lambda mod, args, out, n=mod_name: hook(mod, args, out, n)))
    try:
        with torch.inference_mode():
            bf16_call(r.model, cast_state(r.model), torch.from_numpy(r.mix))
    finally:
        for h in hooks:
            h.remove()
    paths = {}
    for mods, flax_paths in sep.mapped_pairs(r.name, r.model):
        ours = [m for m in mods if m in t_out]
        theirs = [p for p in flax_paths if p in j_out]
        if ours and theirs:
            for m, p in {(min(ours, key=len), min(theirs, key=len)),
                         (max(ours, key=len), max(theirs, key=len))}:
                paths[m] = p
    # A port wrapper (a Sequential with its activation) around the module
    # that holds a flax module's tensors is not that flax module.
    paths = {m: p for m, p in paths.items()
             if not any(o.startswith(m + ".") and q == p for o, q in paths.items())}
    rows = []
    for m in order:
        if m in paths:
            a = _as_jax_layout(t_out[m], j_out[paths[m]])
            rows.append((m or "<model>", "/".join(paths[m]),
                         None if a is None else sep.rel_l2(a, j_out[paths[m]])))
    # The first attention's parts, each side on its own input (on a commit
    # that has the port's flax_attention).
    if name == "DPTNetModel" and hasattr(layers, "flax_attention"):
        att = r.model.separator.dptnet.row_transformer[0].self_attn
        pre = "separator.dptnet.row_transformer.0.self_attn."
        jp = ("row_transformer_0", "self_attn")
        st = cast_state(r.model)
        w_in, b_in, w_out, b_out = (st[pre + n] for n in ("in_proj_weight", "in_proj_bias",
                                                          "out_proj.weight", "out_proj.bias"))
        x = torch.from_numpy(t_in["separator.dptnet.row_transformer.0.self_attn"]).bfloat16()
        with torch.no_grad():
            parts = [layers._dense(x, w, b).float().numpy()
                     for w, b in zip(w_in.chunk(3), b_in.chunk(3))]
            out, weights = layers.flax_attention(x, x, x, att.num_heads, w_in, b_in, w_out,
                                                 b_out)
        jq, jk, jv = (j_out[jp + (n,)] for n in ("query", "key", "value"))
        j_weights = jax.jit(nn.dot_product_attention_weights)(
            *(jnp.asarray(a).astype(jnp.bfloat16) for a in (jq, jk)))
        for label, ours, theirs in (
                ("q", parts[0], jq.reshape(jq.shape[0], jq.shape[1], -1)),
                ("k", parts[1], jk.reshape(jk.shape[0], jk.shape[1], -1)),
                ("v", parts[2], jv.reshape(jv.shape[0], jv.shape[1], -1)),
                ("weights", weights.float().numpy(), np.asarray(j_weights, np.float32)),
                ("output", out.float().numpy(), j_out[jp]),
                ("residual (norm_attn's input)",
                 t_in["separator.dptnet.row_transformer.0.norm_attn"],
                 j_in[("row_transformer_0", "norm_attn")])):
            rows.append((f"separator.dptnet.row_transformer.0.self_attn: {label}",
                         "/".join(jp) + f": {label}", sep.rel_l2(ours, theirs)))
    return rows


def main(wanted) -> None:
    if "--trace" in wanted:
        torch.set_num_threads(1)
        for name in sorted(wanted - {"--trace"}) or ("DPTNetModel", "SkiMNet"):
            for port, flax_path, dist in trace(name):
                print(json.dumps({"model": name, "port": port, "jax": flax_path,
                                  "rel_l2": dist}), flush=True)
        return
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
