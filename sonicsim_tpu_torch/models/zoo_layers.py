"""Shared blocks of the separation zoo.

Port of ``sonicsim_tpu.models.zoo_layers`` (reference
separation/look2hear/models/{sudormrf,afrcnn,TDANet}.py GlobLN /
ConvNormAct / DilatedConvNorm, dprnn.py:70-165 dual-path chunking and RNN
blocks, bsrnn.py:6-48 ResRNN), under the reference's parameter names so a
reference ``state_dict`` loads as it is. Convolutions are ``Conv1d``
(``groups=`` for the grouped and depthwise ones) on (B, C, T); the
recurrent blocks work on channel-last (B, T, C), as ``nn.LSTM`` reads it.

LSTMs. ``LSTMLayer`` is ``nn.LSTM(batch_first=True)`` returning the
output sequence alone; a bidirectional one concatenates [forward,
backward] along the channels, as flax's ``nn.Bidirectional`` does. Its
dtypes are flax's: the cell makes its zero carry in float32 (its
``param_dtype``), so on bfloat16 weights and a bfloat16 input it returns
float32, and the model runs in float32 after it; an initial state passed
in sets the carry's dtype. The recurrence runs in float32 (or wider) on
the weights cast up, and only its output and final state take the
promoted dtype: cuDNN's bfloat16 RNN is not the JAX cell's function. The
input projection is flax's: on a bfloat16 input and bfloat16 weights flax
rounds ``W_ih·x`` (the GRU's ``W_ih·x + b_ih``) to bfloat16 before the
float32 gates, so the port computes it, rounds it, and feeds it to the
float32 recurrence through an identity input weight (:func:`_run_wide`).
The JAX package's ``OptimizedLSTMCell`` keeps per-gate denses (gates i, f, g, o)
and one bias per gate, equal to torch's ``bias_ih + bias_hh``; ``bridge``
carries that bias into ``bias_ih`` and zeros into ``bias_hh``, so weights
cross flax→torch→flax exactly and torch→flax→torch as the same function.
On the card ``nn.LSTM`` runs cuDNN's RNN, whose float32 is full float32
only with ``torch.backends.cudnn.allow_tf32`` off (``scripts.common
.strict_float32``). Its forward agrees with the CPU's to about 1e-6 of the
output; its gradients lie further from float64 than the CPU's float32 ones
(ROADMAP C12).

No block applies dropout: the JAX models never do, in training either.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.lstm_cell import bf16_lstm, f32_carry_lstm
from .layers import Conv1d, Linear, PReLU, group_norm, float32_or_wider

F32_EPS = 1.1920929e-7  # torch.finfo(torch.float32).eps: GroupNorm1's epsilon


def ignore_on_load(module: nn.Module, *names: str) -> None:
    """Let ``load_state_dict`` skip the entries ``names`` of ``module``: the
    constant tables a reference checkpoint carries as buffers (positional
    encodings, inverse frequencies), which the port computes as the JAX
    package does instead of reading them."""
    def hook(mod, state_dict, prefix, *args):
        for name in names:
            state_dict.pop(prefix + name, None)

    module.register_load_state_dict_pre_hook(hook)


class PrefixTable:
    """Rows ``[0, n)`` of a constant table whose rows do not depend on ``n``
    (positional encodings), made by ``make(n)`` as float32 numpy. One table
    is kept, for the longest ``n`` asked for and the last device, so serving
    spans of many lengths costs one table, not one per length."""

    def __init__(self, make):
        self.make, self.rows = make, None

    def __call__(self, n: int, device) -> torch.Tensor:
        rows = self.rows
        if rows is None or rows.shape[0] < n or rows.device != torch.device(device):
            longest = max(n, 0 if rows is None else rows.shape[0])
            # Outside inference mode: a table first made while serving is
            # still usable in a training step's backward.
            with torch.inference_mode(False):
                self.rows = rows = torch.from_numpy(self.make(longest)).to(device)
        return rows[:n]


class GlobLN(nn.Module):
    """gLN over (C, T) per sample on (B, C, T), ``gamma``/``beta`` of shape
    (C,) (the zoo's GlobLN; ``layers.GlobalLayerNorm`` keeps ConvTasNet's
    (C, 1)). Epsilon 1e-8 in the zoo's blocks, 1e-5 where the JAX models
    take ``GlobalLayerNorm``'s default."""

    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        centred = x - x.mean(dim=(1, 2), keepdim=True)
        var = (centred * centred).mean(dim=(1, 2), keepdim=True)
        return self.gamma[:, None] * centred * torch.rsqrt(var + self.eps) + self.beta[:, None]


class GroupNorm1(nn.Module):
    """``nn.GroupNorm(1, C)``: statistics over the channels and every other
    non-batch axis, per-channel affine (``weight``, ``bias``). On (B, C, ...)
    or, with ``channel_last``, on (B, ..., C)."""

    def __init__(self, dim: int, eps: float = F32_EPS, channel_last: bool = False):
        super().__init__()
        self.eps, self.channel_last = eps, channel_last
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.channel_last:
            x = x.movedim(-1, 1)
        y = group_norm(x, 1, self.weight, self.bias, self.eps)
        return y.movedim(1, -1) if self.channel_last else y


class StatelessBatchNorm(nn.Module):
    """Batch statistics over every non-channel axis of a channel-last tensor
    with a per-channel affine (``weight``, ``bias``), no running statistics;
    with ``use_running_stats`` the frozen ``running_mean``/``running_var``
    of an eval-mode ``BatchNorm`` instead.

    Under a mesh the JAX package reduces the statistics over the global
    batch. So a replica (``parallel.mesh.replicate``) takes them over every
    replica's shard (:func:`_global_moments`, through
    ``parallel.mesh.all_reduce_sum``). A replica run outside
    ``parallel_apply`` raises rather than normalise its shard by its own
    statistics."""

    def __init__(self, dim: int, eps: float = 1e-5, use_running_stats: bool = False):
        super().__init__()
        self.eps, self.use_running_stats = eps, use_running_stats
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        if use_running_stats:
            self.register_buffer("running_mean", torch.zeros(dim))
            self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_running_stats:
            mu, var = self.running_mean, self.running_var
        elif getattr(self, "_is_replica", False):
            mu, var = _global_moments(x)
        else:
            axes = tuple(range(x.dim() - 1))
            mu = x.mean(dim=axes, keepdim=True)
            var = x.var(dim=axes, keepdim=True, unbiased=False)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def _global_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The mean and (biased) variance over every non-channel axis of the
    replicas' shards of one batch, on this replica's device: each shard's
    own ``mean`` and ``var`` (torch's reductions, as the unsharded norm
    takes them), combined by their item counts as Chan et al.'s pairwise
    update does, ``var = Σ (n_i / n)(var_i + (mean_i − mean)²)``. A mesh of
    one device gives the unsharded statistics bit for bit."""
    from ..parallel.mesh import all_reduce_sum, replica_context

    if replica_context() is None:
        raise RuntimeError(
            "StatelessBatchNorm: a mesh replica with batch statistics runs outside its "
            "replica context; call the replicas through parallel.mesh.parallel_apply")
    axes = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    share = n / all_reduce_sum(n)
    mu_i = x.mean(dim=axes, keepdim=True)
    var_i = x.var(dim=axes, keepdim=True, unbiased=False)
    mu = all_reduce_sum(mu_i * share)
    var = all_reduce_sum((var_i + (mu_i - mu) ** 2) * share)
    return mu, var


def _conv(nin: int, nout: int, k: int, stride: int, dilation: int, groups: int,
          bias: bool) -> Conv1d:
    """The zoo's conv: the symmetric torch pad ``dilation·(k − 1)//2``
    (sudormrf.py:62, :129)."""
    return Conv1d(nin, nout, k, stride=stride, padding=dilation * ((k - 1) // 2),
                  dilation=dilation, groups=groups, bias=bias)


class ConvNormAct(nn.Module):
    """Conv1d + gLN + PReLU (sudormrf.py:47-71): ``conv``, ``norm``, ``act``."""

    def __init__(self, nin: int, nout: int, kernel_size: int, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.conv = _conv(nin, nout, kernel_size, stride, 1, groups, True)
        self.norm = GlobLN(nout)
        self.act = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


class ConvNorm(nn.Module):
    """Conv1d + gLN, no activation (sudormrf.py:73-94): ``conv``, ``norm``."""

    def __init__(self, nin: int, nout: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.conv = _conv(nin, nout, kernel_size, stride, 1, groups, bias)
        self.norm = GlobLN(nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class NormAct(nn.Module):
    """gLN + PReLU (sudormrf.py:96-112): ``norm``, ``act``."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = GlobLN(dim)
        self.act = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(x))


class DilatedConvNorm(nn.Module):
    """Dilated (depthwise) conv + gLN (sudormrf.py:135-156): ``conv``,
    ``norm``."""

    def __init__(self, nin: int, nout: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1):
        super().__init__()
        self.conv = _conv(nin, nout, kernel_size, stride, dilation, groups, True)
        self.norm = GlobLN(nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class LSTMLayer(nn.LSTM):
    """A uni- or bidirectional LSTM over axis 1 of (B, T, C) →
    (B, T, H · directions), zero initial state: one layer, or a stack of
    ``num_layers`` (the enhancement models' ``SequenceModel``).

    ``bias_hh`` is frozen (``requires_grad=False``): flax's cell has one bias
    per gate, ``bias_ih + bias_hh`` here, so training moves ``bias_ih``
    alone. With both trainable, Adam would move the sum twice as far and the
    global-norm clip would count its gradient twice; frozen, the train step
    is optax's. A reference checkpoint's ``bias_hh`` still loads and adds
    in.

    The recurrence and carry are float32 (or wider), as flax's with its
    float32 carry, unless the input, the weights and the initial state are
    all bfloat16: then flax's bfloat16 cell (:func:`_run_wide`), outputs
    and final state bfloat16, in inference and in training (its gradients
    the JAX scan's, ``ops.lstm_cell.bf16_lstm``). A float32 carry on
    bfloat16 weights trains through ``ops.lstm_cell.f32_carry_lstm``
    (:func:`_f32_carry_training`), whose weight gradients are the JAX
    scan's bfloat16 running sums over the steps."""

    def __init__(self, input_size: int, hidden: int, bidirectional: bool = False,
                 num_layers: int = 1):
        super().__init__(input_size, hidden, num_layers=num_layers, batch_first=True,
                         bidirectional=bidirectional)
        for name, p in self.named_parameters():
            if name.startswith("bias_hh"):
                p.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return self.run(x)[0]

    def run(self, x: torch.Tensor, hx=None):
        """``nn.LSTM``'s own call: ``(output, (h_n, c_n))`` from the initial
        state ``hx = (h_0, c_0)``, each (directions, B, H), or zeros, in
        the dtypes of the module's docstring."""
        return _run_wide(self, nn.LSTM.forward, torch._VF.lstm, 2, x, hx, False)


class GRULayer(nn.GRU):
    """A uni- or bidirectional GRU over axis 1 of (B, T, C) →
    (B, T, H · directions), zero initial state, with flax's ``GRUCell``
    gates (the enhancement models' ``sequence_model="GRU"``).

    flax computes r = σ(W_ir·x + b_ir + W_hr·h), z = σ(W_iz·x + b_iz +
    W_hz·h) and n = tanh(W_in·x + b_in + r ⊙ (W_hn·h + b_hn)), h′ = (1 − z)·n
    + z·h: torch's formula with no hidden bias on r and z. So ``bias_ih`` is
    (b_ir, b_iz, b_in) and ``bias_hh`` is (0, 0, b_hn), and a gradient hook
    keeps the r and z thirds of ``bias_hh`` where they are: Adam and the
    global-norm clip see flax's biases alone, as for the LSTM's frozen
    ``bias_hh``. A reference checkpoint's nonzero thirds still load and add
    in. The carry and the recurrence are float32 (or wider), as
    :class:`LSTMLayer`'s; a bfloat16 carry raises (no JAX caller)."""

    def __init__(self, input_size: int, hidden: int, bidirectional: bool = False,
                 num_layers: int = 1):
        super().__init__(input_size, hidden, num_layers=num_layers, batch_first=True,
                         bidirectional=bidirectional)
        for name, p in self.named_parameters():
            if name.startswith("bias_hh"):
                p.register_hook(functools.partial(_keep_rz, 2 * hidden))

    def frozen_elements(self) -> dict:
        """Each parameter name → the boolean mask of its elements no flax
        parameter holds (the r and z thirds of each ``bias_hh``)."""
        out = {}
        for name, p in self.named_parameters():
            if name.startswith("bias_hh"):
                mask = torch.zeros(p.shape, dtype=torch.bool)
                mask[: 2 * self.hidden_size] = True
                out[name] = mask
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return self.run(x)[0]

    def run(self, x: torch.Tensor, hx=None):
        """``nn.GRU``'s own call, ``(output, h_n)``, in the dtypes of
        :meth:`LSTMLayer.run`."""
        return _run_wide(self, nn.GRU.forward, torch._VF.gru, 1, x, hx, True)


def _run_wide(rnn: nn.RNNBase, own, op, n_states: int, x: torch.Tensor, hx,
              input_bias: bool):
    """``rnn``'s call with the recurrence and carry in float32 or wider:
    ``own`` (its class's ``forward``) where the input, weights and state
    already share that dtype, else ``op`` (``torch._VF.lstm`` or ``.gru``)
    on them cast up, the output and the state (``n_states`` tensors, a
    tuple of them for the LSTM) cast back to their promoted dtype.

    Where the input and the weights promote to a dtype narrower than the
    recurrence's (a bfloat16 input on bfloat16 weights), the first layer's
    input projection is rounded to it as flax's input dense rounds it
    (:func:`_rounded_projection`; with the bias where ``input_bias``, the
    GRU's). Later layers read the first one's float32 output, as each
    layer of flax's stack is its own ``nn.RNN``.

    Where the carry too is bfloat16 (the input, the weights and the state
    promote to it), flax's cell computes in bfloat16: :func:`_bf16_cell`,
    the kernels of ``ops.lstm_cell``, forward and, while autograd records,
    backward."""
    # By name: ``torch.func.functional_call`` swaps the attributes, not
    # ``_flat_weights``.
    weights = [getattr(rnn, n) for n in rnn._flat_weights_names]
    states = () if hx is None else tuple(hx) if isinstance(hx, (tuple, list)) else (hx,)
    out = torch.promote_types(x.dtype, weights[0].dtype)
    out = torch.promote_types(out, states[0].dtype if states else torch.float32)
    run = float32_or_wider(out)
    if x.dtype == weights[0].dtype == run and all(s.dtype == run for s in states):
        return own(rnn, x, hx)
    if out == torch.bfloat16:
        return _bf16_cell(rnn, x, weights, states)
    return _wide_recurrence(rnn, op, n_states, x, weights, states, input_bias)


def _wide_recurrence(rnn: nn.RNNBase, op, n_states: int, x: torch.Tensor, weights: list,
                     states: tuple, input_bias: bool):
    """:func:`_run_wide`'s float32 (or wider) recurrence, whatever the
    carry's dtype: ``op`` on the input, the weights and the state (zeros
    where ``states`` is empty) cast up, the first layer's input projection
    rounded to the narrower dtype of the input and the weights, the output
    and the state cast back to the dtype all three promote to."""
    out = torch.promote_types(x.dtype, weights[0].dtype)
    out = torch.promote_types(out, states[0].dtype if states else torch.float32)
    run = float32_or_wider(out)
    if not states:
        states = (x.new_zeros(rnn.num_layers * (2 if rnn.bidirectional else 1), x.shape[0],
                              rnn.hidden_size, dtype=run),) * n_states
    wide = tuple(s.to(run) for s in states)
    if n_states == 2 and _trains_bf16_weights(run, weights):
        y, h = _f32_carry_training(rnn, x, weights, wide)
        return y.to(out), tuple(s.to(out) for s in h)
    x_run, w_run = x.to(run), [w.to(run) for w in weights]
    narrow = torch.promote_types(x.dtype, weights[0].dtype)
    if narrow != run:
        x_run, w_run = _rounded_projection(rnn, x_run, w_run, narrow, input_bias)
    y, *h = op(x_run, wide if n_states > 1 else wide[0], w_run, rnn.bias, rnn.num_layers,
               float(rnn.dropout), rnn.training, rnn.bidirectional, rnn.batch_first)
    h = tuple(s.to(out) for s in h)
    return y.to(out), h if n_states > 1 else h[0]


def _trains_bf16_weights(run: torch.dtype, weights: list) -> bool:
    """Whether a float32-carry LSTM trains bfloat16 weights (a bfloat16
    train step): then :func:`_f32_carry_training`, else cuDNN's float32
    recurrence with its own weight gradients, a float32 sum over the steps
    rounded once (what a GRU on bfloat16 weights keeps: no bfloat16 step
    trains one, ``infer.precision.BF16_TRAIN_REFUSED``)."""
    return run == torch.float32 and weights[0].dtype == torch.bfloat16 \
        and torch.is_grad_enabled() and any(w.requires_grad for w in weights)


def _f32_carry_training(rnn: nn.RNNBase, x: torch.Tensor, weights: list, states: tuple):
    """A float32-carry LSTM on bfloat16 weights while autograd records (a
    bfloat16 train step): each layer through ``ops.lstm_cell.f32_carry_lstm``,
    whose weight gradients are the JAX scan's bfloat16 running sums, the
    first on ``x`` as it is (flax's input dense rounds on a bfloat16 input),
    each later one on the float32 output before it, as each layer of flax's
    stack is its own ``nn.RNN``. ``states``: ``(h0, c0)``, float32."""
    n_dir = 2 if rnn.bidirectional else 1
    per_dir = len(weights) // (rnn.num_layers * n_dir)
    reverse = [d == 1 for d in range(n_dir)]
    hs, cs = [], []
    for layer in range(rnn.num_layers):
        w = [weights[(layer * n_dir + d) * per_dir:(layer * n_dir + d + 1) * per_dir]
             for d in range(n_dir)]
        bias = [(p[2], p[3]) if rnn.bias else (p[0].new_zeros(p[0].shape[0]),) * 2 for p in w]
        lanes = slice(layer * n_dir, (layer + 1) * n_dir)
        x, h, c = f32_carry_lstm(x, torch.stack([p[0] for p in w]),
                                 torch.stack([p[1] for p in w]),
                                 torch.stack([b[0] for b in bias]),
                                 torch.stack([b[1] for b in bias]), states[0][lanes],
                                 states[1][lanes], reverse, rnn.training)
        hs.append(h)
        cs.append(c)
    return x, (torch.cat(hs), torch.cat(cs))


def _bf16_cell(rnn: nn.RNNBase, x: torch.Tensor, weights: list, states: tuple):
    """``rnn``'s call where the input, the weights and the carry are all
    bfloat16: flax's cell computed in bfloat16, each op rounded
    (``ops.lstm_cell``), on the rounded input projection; outputs and
    final state bfloat16. Only a one-layer LSTM has a JAX caller (the SkiM
    ``SegLSTM`` whose zero carry takes its input's dtype)."""
    name = type(rnn).__name__
    if not isinstance(rnn, nn.LSTM):
        raise NotImplementedError(f"{name}: a bfloat16 carry (flax's GRU cell in bfloat16) "
                                  f"has no JAX caller and is not ported")
    if rnn.num_layers != 1:
        raise NotImplementedError(f"{name}: a bfloat16 carry through {rnn.num_layers} layers "
                                  f"has no JAX caller and is not ported")
    n_dir = 2 if rnn.bidirectional else 1
    per_dir = len(weights) // n_dir
    w = [weights[d * per_dir:(d + 1) * per_dir] for d in range(n_dir)]
    # flax's one bias per gate: bias_ih + bias_hh in float32, rounded once.
    bias = [(p[2].float() + p[3].float()).to(torch.bfloat16) if rnn.bias
            else x.new_zeros(p[1].shape[0], dtype=torch.bfloat16) for p in w]
    h0, c0 = (s.to(torch.bfloat16) for s in states)
    y, h, c = bf16_lstm(x, torch.stack([p[0] for p in w]).to(torch.bfloat16),
                        torch.stack([p[1] for p in w]).to(torch.bfloat16), torch.stack(bias),
                        h0, c0, [d == 1 for d in range(n_dir)])
    return y, (h, c)


def _rounded_projection(rnn: nn.RNNBase, x: torch.Tensor, weights: list, narrow: torch.dtype,
                        input_bias: bool) -> tuple[torch.Tensor, list]:
    """The first layer's input projection of ``x`` (B, T, C), computed in
    ``x``'s dtype and rounded to ``narrow``, as the new input of a first
    layer whose ``weight_ih`` is an identity (``bias_ih`` zero where
    ``input_bias`` folds it into the projection): ``(x′, weights′)``. A
    bidirectional layer's two directions project ``x`` with their own
    weights, so ``x′`` is ``[x′_forward, x′_reverse]`` on the channels and
    each direction's identity reads its own half. A rounded value times 1
    is exact in float32 and in TF32 alike, so the recurrence sees the
    rounded projection as it is; gradients reach ``weight_ih`` (and
    ``bias_ih``) through the projection and its casts."""
    n_dir = 2 if rnn.bidirectional else 1
    per_dir = len(weights) // (rnn.num_layers * n_dir)
    gates = weights[0].shape[0]
    eye = torch.eye(gates * n_dir, dtype=x.dtype, device=x.device)
    weights, parts = list(weights), []
    for d in range(n_dir):
        i = d * per_dir
        proj = x @ weights[i].t()
        if input_bias:
            proj = proj + weights[i + 2]
            weights[i + 2] = torch.zeros_like(weights[i + 2])
        parts.append(proj.to(narrow).to(x.dtype))
        weights[i] = eye[d * gates:(d + 1) * gates]
    return torch.cat(parts, dim=-1) if n_dir > 1 else parts[0], weights


def _keep_rz(n: int, grad: torch.Tensor) -> torch.Tensor:
    """``grad`` with its first ``n`` elements (a GRU ``bias_hh``'s r and z
    thirds) zero."""
    grad = grad.clone()
    grad[:n] = 0
    return grad


def recurrent_layer(kind: str, input_size: int, hidden: int, bidirectional: bool = False,
                    num_layers: int = 1) -> nn.Module:
    """``LSTMLayer`` for the JAX ``sequence_model`` name ``"LSTM"``, else
    ``GRULayer``, as the JAX ``SequenceModel`` picks its cell."""
    cls = LSTMLayer if kind == "LSTM" else GRULayer
    return cls(input_size, hidden, bidirectional, num_layers)


class ResRNN(nn.Module):
    """Residual norm → BLSTM → projection (bsrnn.py:6-26) on (B, T, C):
    ``norm``, ``rnn``, ``proj``."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = True):
        super().__init__()
        self.norm = GroupNorm1(input_size, channel_last=True)
        self.rnn = LSTMLayer(input_size, hidden_size, bidirectional)
        self.proj = Linear(hidden_size * (2 if bidirectional else 1), input_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.proj(self.rnn(self.norm(x)))


# --- dual-path chunking (dprnn.py:260-318 semantics, channel-last) ---------


def segment_sequence(x: torch.Tensor, chunk: int) -> tuple[torch.Tensor, int]:
    """(B, T, N) → (B, S, K, N) chunks of ``chunk`` frames at 50% overlap,
    and the ``gap`` of zeros appended to T (the JAX package's formula,
    ``chunk − (chunk//2 + T mod chunk) mod chunk``)."""
    b, t, n = x.shape
    p = chunk // 2
    gap = chunk - (p + t % chunk) % chunk
    x = F.pad(x, (0, 0, p, p + gap))
    t_pad = x.shape[1]
    seg1 = x[:, : t_pad - p].reshape(b, -1, chunk, n)
    seg2 = x[:, p:].reshape(b, -1, chunk, n)
    return torch.stack([seg1, seg2], dim=2).reshape(b, -1, chunk, n), gap


def overlap_add_sequence(x: torch.Tensor, gap: int) -> torch.Tensor:
    """(B, S, K, N) → (B, T, N): the inverse of :func:`segment_sequence`."""
    b, s, k, n = x.shape
    p = k // 2
    x = x.reshape(b, -1, 2 * k, n)
    x1 = x[:, :, :k].reshape(b, -1, n)[:, p:]
    x2 = x[:, :, k:].reshape(b, -1, n)[:, :-p]
    out = x1 + x2
    return out[:, :-gap] if gap > 0 else out


class DualRNNBlock(nn.Module):
    """Intra-chunk then inter-chunk RNN, each with a projection, a
    GroupNorm(1) and a residual (dprnn.py:70-165), on (B, S, K, N)."""

    def __init__(self, out_channels: int, hidden_channels: int, bidirectional: bool = False):
        super().__init__()
        width = hidden_channels * (2 if bidirectional else 1)
        self.intra_rnn = LSTMLayer(out_channels, hidden_channels, bidirectional)
        self.intra_linear = Linear(width, out_channels)
        self.intra_norm = GroupNorm1(out_channels, channel_last=True)
        self.inter_rnn = LSTMLayer(out_channels, hidden_channels, bidirectional)
        self.inter_linear = Linear(width, out_channels)
        self.inter_norm = GroupNorm1(out_channels, channel_last=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, k, n = x.shape
        intra = self.intra_linear(self.intra_rnn(x.reshape(b * s, k, n)))
        x = x + self.intra_norm(intra.reshape(b, s, k, n))
        inter = x.transpose(1, 2).reshape(b * k, s, n)
        inter = self.inter_linear(self.inter_rnn(inter)).reshape(b, k, s, n)
        return x + self.inter_norm(inter.transpose(1, 2))
