"""bf16 for the separation zoo in the port, against the JAX package's bf16, on
the CPU, from the same seeded weights carried across by the bridge:

* (a) the served output's rel-L2 three ways: JAX bf16 against JAX float32,
  port bf16 against port float32, port bf16 against JAX bf16; the port's
  bf16 really rounds (its distance from float32 is not 0) and leaves the
  model's parameters float32;
* (b) the dtype schedule: every module the bridge maps (the port module and
  the flax module whose parameters are the same tensors, found by marking
  each port tensor with its own value and reading where ``to_flax`` puts
  it) returns the dtypes JAX's returns, read with forward hooks and with
  ``capture_intermediates``; the whole-model bfloat16 form (every floating
  result in bfloat16, as the port's earlier ``.to(bfloat16)`` copy
  computed) fails it;
* (c) the bf16 train step on one batch, 3 steps on each side, with the
  config's loss: every loss finite and falling, the first bf16 loss within
  0.1·|f32| + 0.5 of the float32 one, and the port's first bf16 loss
  within that of JAX's (tests/test_train.py:177-206's rule);
* (d) the refusals: TDANet and MossFormer2, whose JAX bf16 forward raises
  ``TypeError``, raise ``NotImplementedError`` naming themselves and the
  JAX line, in ``bf16_forward`` and in ``make_train_step``.

Gate: rel-L2 0.05 for every model (ConvTasNet's bound, tests/test_torch_models.py), and
port bf16 against JAX bf16 within ``PORT_VS_JAX`` where a model has a tighter bound: DPRNN's
read 1.08e-3 before the port rounded its first LSTM's input projection as flax does
(zoo_layers._rounded_projection) and 1.09e-4 after (tests/bf16_rnn_distance.py). Widths are
tests/test_torch_zoo_models.py's and tests/test_torch_skim.py's; inputs
0.25 s. Each model's JAX functions are jitted once per file.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import sonicsim_tpu.infer as JI
import sonicsim_tpu.models as JM
from sonicsim_tpu.infer.precision import bf16_forward as j_bf16_forward
from sonicsim_tpu.infer.precision import cast_floating
from sonicsim_tpu.train import make_train_step as j_make_train_step
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.infer import to_waveform
from sonicsim_tpu_torch.infer.precision import (BF16_MODELS, BF16_REFUSED, BF16_TRAIN_REFUSED,
                                                bf16_call, bf16_forward, cast_state,
                                                require_bf16, to_float32)
from sonicsim_tpu_torch.models import base as TB
from sonicsim_tpu_torch.train import make_optimizer, make_train_step

from test_torch_sep_train import _pit
from test_torch_sep_train import _seeded as seeded
from test_torch_skim import SMALL as SKIM_SMALL
from test_torch_zoo_models import SMALL as ZOO_SMALL
from torch_threads import one_intra_op_thread  # noqa: F401

BF16_REL_L2 = 0.05
PORT_VS_JAX = {"DPRNNTasNet": 3.3e-4}  # 3x its reading
T = 4000  # 0.25 s at 16 kHz
LR = 1e-3
STEPS = 3
SEP = {
    "DPRNNTasNet": ZOO_SMALL["DPRNNTasNet"],
    "DPTNetModel": ZOO_SMALL["DPTNetModel"],
    "SuDORMRF": ZOO_SMALL["SuDORMRF"],
    "AFRCNN": ZOO_SMALL["AFRCNN"],
    "BSRNN": ZOO_SMALL["BSRNN"],
    "TFGridNet": ZOO_SMALL["TFGridNet"],
    "MossFormer": ZOO_SMALL["MossFormer"],
    "SkiMNet": dict(SKIM_SMALL, causal=False, seg_overlap=True),  # skim.yaml's mode
}


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def batch(n_src: int, seed: int = 0):
    """A (2, T) mixture and (2, n_src, T) targets a tenth of its scale."""
    rng = np.random.default_rng(seed)
    mix = (0.3 * rng.standard_normal((2, T))).astype(np.float32)
    tgt = (0.03 * rng.standard_normal((2, n_src, T))).astype(np.float32)
    return mix, tgt


# --- (b) the dtype schedule ---------------------------------------------------


def _mark(state_dict: dict) -> dict:
    """Each floating tensor filled with its own index + 1; the LSTMs'
    ``bias_hh`` with 0 (the bridge adds it into flax's one bias per gate)."""
    return {k: torch.full_like(v, 0.0 if ".bias_hh" in k else float(i + 1))
            if v.is_floating_point() else v for i, (k, v) in enumerate(state_dict.items())}


def mapped_pairs(name: str, model: torch.nn.Module) -> list:
    """``[(port module, flax module path)]`` whose parameters are the same
    tensors under the bridge: the port module's keys reach exactly the flax
    module's leaves and no other. Of nested modules with the same tensors
    (wrappers), the innermost and the outermost pair, on each side."""
    sd = model.state_dict()
    keys = list(sd)
    tree = TB.to_flax(name, _mark(sd), model.model_args())
    leaf_keys = {}  # flax leaf path → port keys
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        vals = {int(u) for u in np.unique(np.asarray(v))} - {0}
        leaf_keys[tuple(p.key for p in path)] = frozenset(keys[u - 1] for u in vals)
    flax_modules = {}
    for leaf, ks in leaf_keys.items():
        for i in range(1, len(leaf)):
            flax_modules.setdefault(leaf[1:i], set()).add(leaf)  # leaf[0] is "params"
    by_leaves = {}
    for path, leaves in flax_modules.items():
        by_leaves.setdefault(frozenset(leaves), []).append(path)
    pairs = {}
    for mod_name, _ in model.named_modules():
        own = {k for k in keys if mod_name == "" or k.startswith(mod_name + ".")}
        leaves = frozenset(l for l, ks in leaf_keys.items() if ks & own)
        if not leaves or any(not ks <= own for ks in (leaf_keys[l] for l in leaves)):
            continue
        if not all(k in {kk for l in leaves for kk in leaf_keys[l]} or ".bias_hh" in k
                   or not sd[k].is_floating_point() for k in own):
            continue
        if leaves in by_leaves:
            pairs.setdefault(leaves, ([], by_leaves[leaves]))[0].append(mod_name)
    return list(pairs.values())


def _float_dtypes(out) -> set:
    if isinstance(out, (tuple, list)):
        return set().union(*(_float_dtypes(o) for o in out)) if out else set()
    if isinstance(out, dict):
        return set().union(*(_float_dtypes(o) for o in out.values())) if out else set()
    if torch.is_tensor(out):
        return {str(out.dtype).replace("torch.", "")} if out.is_floating_point() else set()
    dtype = getattr(out, "dtype", None)
    if dtype is not None and jnp.issubdtype(dtype, jnp.floating):
        return {jnp.dtype(dtype).name}
    return set()


def port_dtypes(model: torch.nn.Module, run) -> dict:
    """Module name → the floating dtypes it returned in ``run()``."""
    seen, hooks = {}, []
    for mod_name, m in model.named_modules():
        hooks.append(m.register_forward_hook(
            lambda mod, args, out, n=mod_name: seen.setdefault(n, set()).update(
                _float_dtypes(out))))
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return seen


def jax_dtypes(jm, params, x) -> dict:
    """flax module path → the floating dtypes its ``__call__`` returned under
    the JAX ``bf16_forward``'s casts (a trace, no compile)."""
    def fwd(p, v):
        return jm.apply(cast_floating(p), v.astype(jnp.bfloat16), capture_intermediates=True,
                        mutable=["intermediates"])[1]

    inter = jax.eval_shape(fwd, params, jax.ShapeDtypeStruct(x.shape, jnp.float32))
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if k == "__call__":
                out[path] = _float_dtypes(v)
            elif isinstance(v, dict):
                walk(v, path + (k,))

    walk(inter["intermediates"], ())
    return out


def schedule_mismatches(name, model, jm, params, x, run) -> tuple[list, int]:
    """The mapped pairs whose dtypes differ, and how many pairs were held."""
    ours, theirs = port_dtypes(model, run), jax_dtypes(jm, params, x)
    bad, held = [], 0
    for mods, paths in mapped_pairs(name, model):
        mods = [m for m in mods if ours.get(m)]
        paths = [p for p in paths if theirs.get(p)]
        if not mods or not paths:
            continue
        for m, p in {(min(mods, key=len), min(paths, key=len)),
                     (max(mods, key=len), max(paths, key=len))}:
            held += 1
            if ours[m] != theirs[p]:
                bad.append((m or "<model>", "/".join(p) or "<model>", sorted(ours[m]),
                            sorted(theirs[p])))
    return bad, held


_FFTS = {getattr(torch.fft, n) for n in torch.fft.__all__}


class _AllBf16(TorchFunctionMode):
    """Every floating result in bfloat16 (complex ones pass); the FFTs,
    which take no bfloat16, read their input in float32: the whole model
    computing in bfloat16."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _FFTS:
            args = tuple(_cast(a, torch.float32) for a in args)
        return _cast(func(*args, **(kwargs or {})), torch.bfloat16)


def _cast(out, dtype):
    if isinstance(out, (tuple, list)):
        return type(out)(_cast(o, dtype) for o in out)
    if torch.is_tensor(out) and out.is_floating_point() and out.dtype != dtype:
        return out.to(dtype)
    return out


def whole_model_bf16(model, x):
    """The earlier port's bf16 form: every floating tensor of the model and
    every floating result in bfloat16."""
    state = {n: t.to(torch.bfloat16) if t.is_floating_point() else t
             for n, t in {**dict(model.named_parameters()),
                          **dict(model.named_buffers())}.items()}
    with _AllBf16():
        return torch.func.functional_call(model, state, (x.to(torch.bfloat16),))


# --- one model's readings, made once per file -----------------------------------


class Readings:
    """One model's JAX and port forwards on one batch, each JAX function
    jitted once."""

    def __init__(self, name, cfg, params, model, jm, n_src):
        self.name, self.cfg, self.params, self.model, self.jm = name, cfg, params, model, jm
        self.mix, self.tgt = batch(n_src)
        x = jnp.asarray(self.mix)
        self.j32 = jax.jit(jm.apply)(params, x)
        self.j16 = jax.jit(j_bf16_forward(jm))(params, x)
        with torch.inference_mode():
            xt = torch.from_numpy(self.mix)
            self.t32 = model(xt)
            # bf16_forward's own call, which a refused model's bf16_forward refuses.
            self.t16 = to_float32(bf16_call(model, cast_state(model), xt))

    def served(self):
        """The served outputs (``to_waveform``): JAX f32, JAX bf16, port
        f32, port bf16."""
        jw = [np.asarray(JI.to_waveform(self.jm, o, T)) for o in (self.j32, self.j16)]
        with torch.inference_mode():
            tw = [to_waveform(self.model, o, T).numpy() for o in (self.t32, self.t16)]
        return (*jw, *tw)


def check_forward(r: Readings):
    j32, j16, t32, t16 = r.served()
    assert j16.shape == t16.shape == t32.shape == j32.shape and np.isfinite(t16).all()
    dists = rel_l2(j16, j32), rel_l2(t16, t32), rel_l2(t16, j16)
    assert max(dists) < BF16_REL_L2, dists
    assert dists[2] < PORT_VS_JAX.get(r.name, BF16_REL_L2), dists
    assert 0 < dists[1]  # really computed in bfloat16
    with torch.inference_mode():
        served = to_waveform(r.model, bf16_forward(r.model)(torch.from_numpy(r.mix)), T)
    assert np.array_equal(served.numpy(), t16)
    assert all(p.dtype == torch.float32 for p in r.model.parameters())  # the model is untouched
    assert all(b.dtype == torch.float32 for b in r.model.buffers() if b.is_floating_point())


def check_schedule(r: Readings, min_pairs: int = 3):
    x = torch.from_numpy(r.mix)
    state = cast_state(r.model)
    bad, held = schedule_mismatches(r.name, r.model, r.jm, r.params, r.mix,
                                    lambda: bf16_call(r.model, state, x))
    assert held >= min_pairs, held
    assert not bad, bad


def check_step(r: Readings, j_loss, t_loss, make_port):
    """(c): the bf16 step on both sides against each side's float32 loss."""
    mix, tgt = jnp.asarray(r.mix), jnp.asarray(r.tgt)
    j_f32 = float(j_loss(r.j32, tgt))
    opt = __import__("optax").adam(LR)
    j_step = jax.jit(j_make_train_step(r.jm, j_loss, opt, precision="bf16"))
    params, state, j_bf16 = r.params, opt.init(r.params), []
    for _ in range(STEPS):
        params, state, val = j_step(params, state, mix, tgt)
        j_bf16.append(float(val))

    model = make_port()
    t_f32 = float(t_loss(r.t32, torch.from_numpy(r.tgt)))
    step = make_train_step(model, t_loss, make_optimizer(model.parameters(), LR),
                           precision="bf16", clip_norm=None)
    t_bf16 = [float(step(torch.from_numpy(r.mix), torch.from_numpy(r.tgt)))
              for _ in range(STEPS)]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.grad is None or p.grad.dtype == torch.float32 for p in model.parameters())
    for f32, bf16 in ((j_f32, j_bf16), (t_f32, t_bf16)):
        assert np.isfinite(bf16).all() and bf16[-1] < bf16[0], bf16
        assert abs(bf16[0] - f32) < 0.1 * abs(f32) + 0.5, (bf16[0], f32)
    assert abs(t_bf16[0] - j_bf16[0]) < 0.1 * abs(j_bf16[0]) + 0.5, (t_bf16[0], j_bf16[0])


def check_refused(name, model, reason, train_only=False):
    """(d): the port refuses by name with the reason, in ``bf16_forward``
    (unless ``train_only``: serving stays allowed) and in
    ``make_train_step``."""
    pattern = f"{name}.*{re.escape(reason)}"
    if not train_only:
        with pytest.raises(NotImplementedError, match=pattern):
            bf16_forward(model)
    else:
        require_bf16(model)
    with pytest.raises(NotImplementedError, match=pattern):
        make_train_step(model, None, make_optimizer(model.parameters()), precision="bf16")


# --- the separation zoo -----------------------------------------------------------

_READINGS = {}


def readings(name) -> Readings:
    if name not in _READINGS:
        cfg = SEP[name]
        model, params = seeded(name, cfg)
        _READINGS[name] = Readings(name, cfg, params, model.eval(), JM.get(name)(**cfg), 2)
    return _READINGS[name]


def test_the_lists_name_the_zoo():
    assert set(SEP) <= set(BF16_MODELS)
    assert not set(BF16_REFUSED) & set(BF16_MODELS)
    assert set(BF16_TRAIN_REFUSED) <= set(BF16_MODELS) | set(BF16_REFUSED)
    assert not set(SEP) & set(BF16_TRAIN_REFUSED)


@pytest.mark.parametrize("name", list(SEP))
def test_bf16_forward_three_ways(name):
    check_forward(readings(name))


@pytest.mark.parametrize("name", list(SEP))
def test_bf16_dtype_schedule_is_jax(name):
    check_schedule(readings(name))


@pytest.mark.parametrize("name", list(SEP))
def test_bf16_step_tracks_f32_on_both_sides(name):
    r = readings(name)
    loss, j_loss = _pit()
    check_step(r, j_loss, loss, lambda: seeded(name, r.cfg)[0])


def test_whole_model_bf16_fails_the_schedule():
    """DPRNN's LSTMs in bfloat16 stay within the rel-L2 gate, so only the
    schedule tells that form from JAX's."""
    r = readings("DPRNNTasNet")
    x = torch.from_numpy(r.mix)
    with torch.no_grad():
        out = whole_model_bf16(r.model, x)
    assert rel_l2(out.float().numpy(), np.asarray(r.t32)) < BF16_REL_L2
    bad, _ = schedule_mismatches(r.name, r.model, r.jm, r.params, r.mix,
                                 lambda: whole_model_bf16(r.model, x))
    assert any("rnn" in m for m, *_ in bad), bad


@pytest.mark.parametrize("name,cfg", [("TDANet", ZOO_SMALL["TDANet"]),
                                      ("MossFormer2", ZOO_SMALL["MossFormer2"])])
def test_bf16_is_refused_where_jax_raises(name, cfg):
    model, params = seeded(name, cfg)
    jm = JM.get(name)(**cfg)
    with pytest.raises(TypeError, match="same dtypes"):
        jax.eval_shape(j_bf16_forward(jm), params, jax.ShapeDtypeStruct((1, T), jnp.float32))
    check_refused(name, model, "sonicsim_tpu/models/layers.py:156")


# --- §0: the float32 constant tables promote as JAX's do ------------------------------


class _EinsumDtypes(TorchFunctionMode):
    """The operand dtypes of every ``torch.einsum`` call."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.einsum:
            self.seen.append([a.dtype for a in args[1:]])
        return func(*args, **(kwargs or {}))


def _table_dtypes(table: str, dtype: torch.dtype) -> list:
    """The dtypes a repaired table computes in on an input of ``dtype``."""
    from sonicsim_tpu_torch.models import dccrn, mossformer, tdanet

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 1600)).astype(np.float32)).to(dtype)
    if table == "dccrn-window":  # the analysis frames × window reach the FFT
        real, imag = dccrn.conv_stft(x, 400, 100, 512)
        return [real.dtype]
    if table == "dccrn-pinv":  # window and pseudo-inverse, in the synthesis
        spec = torch.zeros(1, 257, 20, dtype=dtype)
        with _EinsumDtypes() as mode:
            out = dccrn.conv_istft(spec, spec, 400, 100, 512, 1600)
        return [mode.seen[0][1], out.dtype]
    if table == "mossformer-rotary":
        return [mossformer._rotary(x.reshape(1, 50, 32), 16).dtype]
    if table == "tdanet-positional":
        attn = tdanet._PositionalAttention(16, False)
        if dtype == torch.float64:
            attn = attn.double()
        state = cast_state(attn) if dtype == torch.bfloat16 else {}
        with torch.no_grad():  # the norm's output plus the table, then the attention
            out = torch.func.functional_call(attn, state, (x.reshape(1, 100, 16),))
        return [out.dtype]
    model = TM.FastFullSubnet(**_FFS_SMALL, device="cpu")  # the mel bank
    if dtype == torch.float64:
        model = model.double()
    state = cast_state(model) if dtype == torch.bfloat16 else {}
    with _EinsumDtypes() as mode, torch.no_grad():
        torch.func.functional_call(model, state, (x.reshape(1, -1)[:, :1600].to(dtype),))
    return [mode.seen[0][1], model.mel_fb.dtype]


_FFS_SMALL = dict(bottleneck_hidden_size=8)
_TABLE_WANT = {torch.bfloat16: torch.float32, torch.float32: torch.float32,
               torch.float64: torch.float64}


@pytest.mark.parametrize("dtype", list(_TABLE_WANT), ids=["bf16", "f32", "f64"])
@pytest.mark.parametrize("table", ["dccrn-window", "dccrn-pinv", "mossformer-rotary",
                                   "tdanet-positional", "fastfullsubnet-mel"])
def test_float32_tables_promote(table, dtype):
    """The constant tables the JAX models build in float32 stay float32 under
    bf16 (and promote what they touch), and a float64 step keeps float64."""
    assert set(_table_dtypes(table, dtype)) == {_TABLE_WANT[dtype]}
