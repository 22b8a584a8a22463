"""SkiM's bfloat16 ``proj`` + ``norm`` pair in training (the port's
``SkiMNorm.after``, ``layers.dense_norm_bf16``), on the CPU, against
``jax.vjp`` of the JAX package's pair (flax's ``Dense``, then
``GroupNorm1`` or the causal ``ChannelLayerNorm``, with a residual as the
JAX ``SegLSTM`` adds it) from the same numpy inputs, the parameters cast to
bfloat16 inside the function as ``make_train_step(precision="bf16")`` casts
them.

The compiled HLO of that VJP (tests/bf16_dense_norm_hlo.py prints it)
rounds the Dense's bias cotangent as a bfloat16 reduce over the rows in
XLA's windows of 32 along each axis longer than 32 (the cLN's channel sums
and its parameters' row sums too), and both GroupNorm(1) flavours (the
norm alone and with the SegLSTM's residual) compile to one schedule.
Every cotangent (the input's, the Dense's kernel and bias, the norm's
scale and shift) within rel-L2 ``REL`` = 4e-4 of ``jax.vjp``'s, 3x the
readings: 0 (bit-equal) on every cotangent of three cases, and on the gLN
at 40 x 40 rows 3.5e-5 on the input and 1.3e-4 on the kernel (float32 sums
taken in another order than XLA's flip a rounding). torch's autograd of
the forward the port ran before (``Linear``, then the norm on the Dense's
float32 sum) misses it: 1.6e-2 to 2.5e-2 on the bias, 3.3e-3 to 5.2e-3 on
the input. The rows (N·K) are above 32 in each case, and the channels (40),
so XLA's windowed reduce runs, along both row axes at 40 x 40.

Also: ``ops.lstm_cell.row_sum_ref`` over several axes equals XLA's bfloat16
reduce, and the forward is bit-for-bit the one the port computed before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as nn
from sonicsim_tpu.infer.precision import cast_floating
from sonicsim_tpu.models.layers import ChannelLayerNorm
from sonicsim_tpu.models.zoo_layers import GroupNorm1
from sonicsim_tpu_torch.models import skim
from sonicsim_tpu_torch.ops.lstm_cell import row_sum_ref

from torch_threads import one_intra_op_thread  # noqa: F401

REL = 4e-4
NAMES = ("x", "kernel", "bias", "scale", "shift")
CASES = {"gln-70x10": (False, 70, 10), "gln-40x40": (False, 40, 40),
         "cln-70x10": (True, 70, 10), "cln-40x40": (True, 40, 40)}
HD, D = 16, 40  # the LSTM's output width and the channels (above 32: a windowed channel sum)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


class Pair(nn.Module):
    causal: bool

    @nn.compact
    def __call__(self, out, x):
        y = nn.Dense(D, name="proj")(out)
        norm = ChannelLayerNorm(D, name="norm") if self.causal else GroupNorm1(name="norm")
        return x + norm(y)


def draw(rng, shape, scale=1.0):
    return np.asarray(jnp.asarray(scale * rng.standard_normal(shape), jnp.bfloat16), np.float32)


def inputs(causal, n, k, seed=0):
    rng = np.random.default_rng(seed)
    out, x, ct = draw(rng, (n, k, HD)), draw(rng, (n, k, D)), draw(rng, (n, k, D))
    w, b = draw(rng, (D, HD), 0.3), draw(rng, (D,), 0.3)
    gamma, beta = draw(rng, (D,), 0.5) + 1.0, draw(rng, (D,), 0.2)
    return out, x, ct, w, b, gamma.astype(np.float32), beta


def jax_grads(causal, out, x, ct, w, b, gamma, beta):
    """``jax.vjp`` of the pair: the cotangents of (out, kernel, bias,
    scale, shift) in the port's layout, float32 numpy."""
    norm = ({"gamma": gamma, "beta": beta} if causal
            else {"GroupNorm_0": {"scale": gamma, "bias": beta}})
    params = {"params": {"proj": {"kernel": w.T, "bias": b}, "norm": norm}}
    model = Pair(causal)

    def f(p, o, xx):
        return model.apply(cast_floating(p), o, xx)

    def vjp(p, o, xx, c):
        return jax.vjp(f, p, o, xx)[1](c)

    as_bf16 = (lambda a: jnp.asarray(a, jnp.bfloat16))
    gp, go, _ = jax.jit(vjp)(jax.tree.map(jnp.asarray, params), as_bf16(out), as_bf16(x),
                             as_bf16(ct))
    gp = gp["params"]
    gn = gp["norm"] if causal else gp["norm"]["GroupNorm_0"]
    return [np.asarray(a, np.float32) for a in
            (go, gp["proj"]["kernel"].T, gp["proj"]["bias"],
             gn["gamma" if causal else "scale"], gn["beta" if causal else "bias"])]


def port_grads(causal, out, x, ct, w, b, gamma, beta, autograd=False):
    """The port's cotangents of (out, weight, bias, gamma, beta), float32
    numpy, and the pair's output; with ``autograd``, torch's autograd of
    the forward the port ran before the repair (``Linear``, then the norm
    on its float32 sum)."""
    seg = skim.SegLSTM(D, HD // 2, True, causal).to(torch.bfloat16)
    proj, norm = seg.proj, seg.norm
    with torch.no_grad():
        for p, a in ((proj.weight, w), (proj.bias, b), (norm.gamma, gamma),
                     (norm.beta, beta)):
            p.copy_(torch.from_numpy(a).reshape(p.shape))
    o = torch.from_numpy(out).to(torch.bfloat16).requires_grad_()
    n = norm(proj(o), proj.unrounded(o)) if autograd else norm.after(proj, o)
    (torch.from_numpy(x).to(torch.bfloat16) + n).backward(
        torch.from_numpy(ct).to(torch.bfloat16))
    grads = [t.grad.float().reshape(-1 if i > 1 else t.shape).numpy() for i, t in
             enumerate((o, proj.weight, proj.bias, norm.gamma, norm.beta))]
    return grads, n.detach()


@pytest.mark.parametrize("case", list(CASES))
def test_dense_norm_gradients_are_jax_vjp(case):
    causal, n, k = CASES[case]
    args = inputs(causal, n, k)
    want = jax_grads(causal, *args)
    got, out = port_grads(causal, *args)
    dists = {nm: rel_l2(g, w) for nm, g, w in zip(NAMES, got, want)}
    equal = {nm: float((g == w).mean()) for nm, g, w in zip(NAMES, got, want)}
    print("rel-L2:", dists, "bit-equal:", equal)
    assert max(dists.values()) <= REL, dists
    before, old_out = port_grads(causal, *args, autograd=True)
    old = {nm: rel_l2(g, w) for nm, g, w in zip(NAMES, before, want)}
    print("torch's autograd rel-L2:", old)
    assert max(old.values()) > REL, old
    assert torch.equal(out, old_out)  # the forward is the one the port ran before


@pytest.mark.parametrize("shape,lead", [((3, 20, 16), 2), ((70, 10, 8), 2), ((10, 70, 8), 2),
                                        ((70, 40, 8), 2), ((64, 5, 7), 1), ((100, 5, 7), 1),
                                        ((33, 33, 4), 2), ((1100, 3, 3), 3)])
def test_row_sum_over_axes_is_xla_bf16_reduce(shape, lead):
    rng = np.random.default_rng(lead * 1000 + shape[0])
    a = draw(rng, shape)
    want = jax.jit(lambda v: jax.lax.reduce(v, jnp.bfloat16(0), jax.lax.add,
                                            tuple(range(lead))))(jnp.asarray(a, jnp.bfloat16))
    t = torch.from_numpy(a)
    assert np.array_equal(row_sum_ref(t.to(torch.bfloat16), lead=lead).numpy(),
                          np.asarray(want, np.float32))
    assert torch.equal(row_sum_ref(t, lead=lead), row_sum_ref(t.to(torch.bfloat16), lead=lead))
