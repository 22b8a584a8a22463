"""flax's bfloat16 LSTM cell in the port (``ops.lstm_cell``), on the CPU.

Where a flax ``OptimizedLSTMCell``'s carry, kernels and input are all
bfloat16 (the JAX SkiM's first ``SegLSTM``, whose zero carry takes the
input's dtype), XLA computes every op of the cell in float32 and rounds its
result to bfloat16. ``bf16_lstm_scan_ref``, the plain version of the Hopper
kernel ``csrc/bf16_lstm.cu``, computes that schedule:

* (a) against flax's ``nn.RNN(OptimizedLSTMCell)`` in bfloat16, forward and
  reversed, from a zero and from a seeded bfloat16 carry: outputs and final
  ``(h, c)`` within rel-L2 1e-4 (the share of bit-equal elements is
  recorded). The float32 recurrence the port ran before (cuDNN's function:
  float32 gates and cell on the rounded projection) misses that bound;
* (b) the port's ``SegLSTM`` against the JAX ``SegLSTM`` in bfloat16, from
  both carries, within the same bound, in the JAX dtypes;
* (c) a ``GRULayer`` with a bfloat16 carry (no JAX caller) raises, naming
  itself.

N=6 rows, K=24 steps, D=16 inputs, H=32 units.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as nn
from sonicsim_tpu.infer.precision import cast_floating
from sonicsim_tpu.models.skim import SegLSTM as JSegLSTM
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch.models.skim import SegLSTM
from sonicsim_tpu_torch.models.zoo_layers import GRULayer, LSTMLayer, _wide_recurrence
from sonicsim_tpu_torch.ops.lstm_cell import bf16_lstm_scan, bf16_lstm_scan_ref

from torch_threads import one_intra_op_thread  # noqa: F401

N, K, D, H = 6, 24, 16, 32
REL = 1e-4
CASES = [(reverse, carry) for reverse in (False, True) for carry in ("zero", "seeded")]


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def seeded(tree, rng, scale=0.3):
    return jax.tree.map(lambda a: jnp.asarray(scale * rng.standard_normal(a.shape),
                                              jnp.bfloat16), tree)


def carries(kind: str, rng, dirs: int):
    """(c, h) per direction, each (N, H) bfloat16: zeros or seeded."""
    if kind == "zero":
        z = jnp.zeros((N, H), jnp.bfloat16)
        return tuple((z, z) for _ in range(dirs))
    return tuple((jnp.asarray(rng.standard_normal((N, H)), jnp.bfloat16),
                  jnp.asarray(np.tanh(rng.standard_normal((N, H))), jnp.bfloat16))
                 for _ in range(dirs))


@pytest.mark.parametrize("reverse,carry", CASES,
                         ids=[f"{'reverse' if r else 'forward'}-{c}" for r, c in CASES])
def test_plain_scan_is_flax_bf16_cell(reverse, carry):
    rng = np.random.default_rng(1 + 2 * reverse + (carry == "seeded"))
    rnn = nn.RNN(nn.OptimizedLSTMCell(H))
    params = seeded(jax.eval_shape(rnn.init, jax.random.key(0), jnp.zeros((N, K, D))), rng)
    x = jnp.asarray(rng.standard_normal((N, K, D)), jnp.bfloat16)
    (c0, h0), = carries(carry, rng, 1)
    xi = x[:, ::-1] if reverse else x
    (jc, jh), jy = jax.jit(lambda p, v, c, h: rnn.apply(p, v, initial_carry=(c, h),
                                                        return_carry=True))(params, xi, c0, h0)
    jy = jy[:, ::-1] if reverse else jy
    sd = bridge._cell_to_torch(jax.tree.map(np.asarray, params["params"]["cell"]), "l", "l0")
    w_ih, w_hh, bias = (torch.from_numpy(np.asarray(sd[f"l.{n}_l0"], np.float32))
                        for n in ("weight_ih", "weight_hh", "bias_ih"))
    xp = (bf16(x).float() @ w_ih.t()).to(torch.bfloat16)  # flax's rounded input dense
    y, h, c = bf16_lstm_scan_ref(xp, w_hh.bfloat16()[None], bias.bfloat16()[None],
                                 bf16(h0)[None], bf16(c0)[None], [reverse])
    assert y.dtype == h.dtype == c.dtype == torch.bfloat16
    want = [np.asarray(a, np.float32) for a in (jy, jh, jc)]
    got = [t.float().numpy() for t in (y, h[0], c[0])]
    dists = [rel_l2(g, w) for g, w in zip(got, want)]
    print("bit-equal share (outputs, h, c):", [float((g == w).mean()) for g, w in zip(got, want)])
    print("rel-L2:", dists)
    assert max(dists) <= REL, dists
    # The entry point on a CPU tensor is the plain version.
    assert all(torch.equal(a, b) for a, b in zip(
        bf16_lstm_scan(xp, w_hh.bfloat16()[None], bias.bfloat16()[None], bf16(h0)[None],
                       bf16(c0)[None], [reverse]), (y, h, c)))
    # The float32 recurrence on the same rounded projection misses the bound.
    layer = LSTMLayer(D, H)
    layer.load_state_dict({k[2:]: torch.from_numpy(np.asarray(v, np.float32))
                           for k, v in sd.items()})
    layer.bfloat16()
    weights = [getattr(layer, n) for n in layer._flat_weights_names]
    with torch.no_grad():
        old, _ = _wide_recurrence(layer, torch._VF.lstm, 2, bf16(xi), weights,
                                  (bf16(h0)[None], bf16(c0)[None]), False)
    old = old.float().numpy()
    old = old[:, ::-1] if reverse else old
    assert rel_l2(old, want[0]) > REL


def _seg_pair(rng):
    jm = JSegLSTM(D, H, bidirectional=True)
    x = jnp.zeros((N, K, D), jnp.float32)
    params = seeded(jax.eval_shape(jm.init, jax.random.key(0), x, None), rng)
    tree = {"params": {"seg_lstm_0": jax.tree.map(np.asarray, params["params"])}}
    spec = [e for e in bridge._skim_spec([0], {}, False) if e[0].startswith("seg_lstm_0")]
    sd = bridge._spec_to_torch(tree["params"], spec)
    model = SegLSTM(D, H, bidirectional=True, causal=False)
    prefix = "separation.skim.seg_lstms.0."
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(np.asarray(v, np.float32))
                           for k, v in sd.items()})
    return jm, params, model.eval()


@pytest.mark.parametrize("carry", ["zero", "seeded"])
def test_seglstm_bf16_is_jax(carry):
    rng = np.random.default_rng(7 + (carry == "seeded"))
    jm, params, model = _seg_pair(rng)
    x = jnp.asarray(rng.standard_normal((N, K, D)), jnp.bfloat16)
    hc = None if carry == "zero" else carries(carry, rng, 2)
    jout, jfinal = jax.jit(lambda p, v, s: jm.apply(cast_floating(p), v, s))(params, x, hc)
    state = {n: p.bfloat16() for n, p in model.named_parameters()}
    port_hc = None if hc is None else tuple(
        torch.stack([bf16(hc[d][i]) for d in range(2)]) for i in (1, 0))  # (h, c)
    with torch.inference_mode():
        out, (h, c) = torch.func.functional_call(model, state, (bf16(x), port_hc))
    assert out.dtype == h.dtype == c.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    assert all(a.dtype == jnp.bfloat16 for d in jfinal for a in d)
    pairs = [(out, jout)] + [(t[d], jfinal[d][i]) for d in range(2) for t, i in ((h, 1), (c, 0))]
    dists = [rel_l2(t.float().numpy(), np.asarray(j, np.float32)) for t, j in pairs]
    print("rel-L2:", dists)
    assert max(dists) <= REL, dists


def test_gru_with_bf16_carry_raises():
    layer = GRULayer(D, H).bfloat16()
    x = torch.zeros(N, K, D, dtype=torch.bfloat16)
    h0 = torch.zeros(1, N, H, dtype=torch.bfloat16)
    with torch.inference_mode(), pytest.raises(NotImplementedError, match="GRULayer"):
        layer.run(x, h0)
