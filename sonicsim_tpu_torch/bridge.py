"""State carried over from the JAX package: RIR banks, rooms, scenes, audio,
plans and model weights.

The render has no learned parameters; its state is the RIR bank, the
host plan tables and the description of the simulated room.
``load_rir_bank`` reads the JAX package's ``.npz`` bank format
(``sim/oracle.save_rir_bank``) without importing it, ``sim_from_fields``
and ``scene_from_fields`` build the port's oracle, channel model and scene
from the plain fields of the JAX package's (``dataclasses.asdict``),
``plan_from_json`` loads a ``mixture_plan.json`` that either package wrote,
``to_torch`` turns numpy banks, audio and plans into tensors on a device
(the card unless the caller asks for the CPU), so both packages can be fed
the same state. ``convtasnet_state_dict`` and ``convtasnet_flax_params``
carry ConvTasNet's weights between the JAX package's flax tree and the
port's ``state_dict`` (the inverse of the JAX package's
``models/torch_import.py:36-67,193-214``).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch


def load_rir_bank(path: str | Path, sample_rate: int = 16000) -> dict:
    """Read a bank ``.npz``: ``rirs (S, R, C, L)`` (float16 or float32 on
    disk, float32 here), ``source_positions (S, 3)``,
    ``receiver_positions (R, 3)``, ``sample_rate`` (an int here;
    ``sample_rate`` where the file has none, as in the reference's reader)
    and any extra metadata arrays, as numpy."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    if data["rirs"].dtype != np.float32:
        data["rirs"] = data["rirs"].astype(np.float32)
    data["sample_rate"] = int(data.get("sample_rate", sample_rate))
    return data


def sim_from_fields(oracle: dict, channel: dict, device=None) -> tuple:
    """The port's ``(SyntheticRirOracle, ChannelModel)`` from plain fields.

    ``oracle`` holds the synthetic oracle's fields (``sample_rate``,
    ``max_order``, ``ir_seconds``, ``seed``, ``n_bands``) and ``room``, a
    dict of ``ShoeboxRoom`` fields (``dims``, the material scalars and
    curves, ``diffraction``); ``channel`` holds ``channel_type``,
    ``channel_order`` and ``mic_array``. ``dataclasses.asdict`` of the JAX
    package's objects gives both. The oracle renders on ``device``."""
    from .sim import ChannelModel, ShoeboxRoom, SyntheticRirOracle

    fields = dict(oracle)
    room = ShoeboxRoom(**fields.pop("room"))
    return (SyntheticRirOracle(room=room, device=device, **fields),
            ChannelModel(**channel))


def scene_from_fields(fields: dict, device=None):
    """The port's ``Scene`` from the plain fields of a synthetic one:
    ``room``, ``nav`` (a dict of ``NavGrid`` fields: ``occupancy``,
    ``origin``, ``resolution``, ``floor_height``), ``oracle`` and
    ``channel`` (as :func:`sim_from_fields` takes them), and optionally
    ``source_height``, ``sensor_height`` and ``acoustic_config``.
    ``dataclasses.asdict`` of the JAX package's ``Scene`` gives them. The
    scene and its oracle run on ``device``."""
    from .sim import NavGrid, Scene

    f = dict(fields)
    oracle, channel = sim_from_fields(f.pop("oracle"), f.pop("channel"),
                                      device=device)
    return Scene(nav=NavGrid(**f.pop("nav")), oracle=oracle, channel=channel,
                 device=device, **f)


def plan_from_json(source):
    """A ``MixturePlan`` from a ``mixture_plan.json`` (a path) or its parsed
    dict, as either package writes it (``MixturePlan.save``)."""
    from .dataset.plan import LongAudioPlan, MixturePlan, Placement

    if not isinstance(source, dict):
        with open(source) as f:
            source = json.load(f)
    d = dict(source)

    def long_audio(p: dict) -> LongAudioPlan:
        return LongAudioPlan(p["total_samples"], p["sample_rate"],
                             [Placement(**x) for x in p["placements"]])

    d["speech_plans"] = [long_audio(p) for p in d["speech_plans"]]
    d["noise_plan"] = long_audio(d["noise_plan"])
    d["music_plan"] = long_audio(d["music_plan"])
    return MixturePlan(**d)


def resolve_device(device=None) -> torch.device:
    """The device to run on: the card unless the caller names another.

    Raises ``RuntimeError`` where the card is wanted (``None`` or a CUDA
    device) and CUDA is absent: the port never falls back to the CPU, which
    runs only when asked for by ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU; pass "
            "device='cpu' to run on the CPU"
        )
    return device


def to_torch(arrays, device=None):
    """Numeric numpy arrays (alone or in dicts, lists and tuples) → tensors
    on ``device`` (the card unless given, see :func:`resolve_device`) with
    their dtypes kept; tensors are moved, anything else (strings, scalars)
    is returned as it is."""
    device = resolve_device(device)
    if isinstance(arrays, np.ndarray) and arrays.dtype.kind in "biufc":
        return torch.from_numpy(np.ascontiguousarray(arrays)).to(device)
    if torch.is_tensor(arrays):
        return arrays.to(device)
    if isinstance(arrays, dict):
        return {k: to_torch(v, device) for k, v in arrays.items()}
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(to_torch(v, device) for v in arrays)
    return arrays


# ConvTasNet's weights. Layouts (flax ↔ torch):
#   Conv1d            (k, in, out)      ↔ (out, in, k)
#   depthwise Conv1d  (k, 1, C)         ↔ (C, 1, k)
#   ConvTranspose1d   (k, in, out)      ↔ (in, out, k), the kernel axis
#                                         flipped (flax does not flip it)
#   gLN gamma/beta    (C,)              ↔ gamma/beta (C, 1)
#   cLN gamma/beta    (C,)              ↔ weight/bias (C,)
#   PReLU alpha       (1,)              ↔ weight (1,)
_BLOCK_RE = re.compile(r"separation\.sep\.(\d+)\.tcn\.(\d+)\.")
_TCN_RE = re.compile(r"tcn_(\d+)_(\d+)$")


def _np(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu()
        return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    return np.asarray(v)


def float32_tensors(state_dict: dict) -> dict:
    """A checkpoint's entries (tensors of any float dtype, or numpy
    arrays) as float32 CPU tensors under the same keys."""
    return {k: (v.detach() if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
                ).to("cpu", torch.float32) for k, v in state_dict.items()}


def convtasnet_flax_params(state_dict: dict) -> dict:
    """The port's (or the reference's) ConvTasNet ``state_dict`` → the JAX
    package's flax params ``{"params": {...}}``, as numpy arrays. The norm
    (gLN or cLN) and the R × X blocks are read from the keys."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    gln = "encoder.norm.gamma" in sd
    norm_name = "GlobalLayerNorm" if gln else "ChannelLayerNorm"

    def conv(key):
        return {"kernel": np.ascontiguousarray(sd[f"{key}.weight"].transpose(2, 1, 0)),
                "bias": sd[f"{key}.bias"]}

    def norm(key):
        g, b = ("gamma", "beta") if gln else ("weight", "bias")
        return {"gamma": sd[f"{key}.{g}"].reshape(-1), "beta": sd[f"{key}.{b}"].reshape(-1)}

    p = {"encoder": conv("encoder.encoder"), f"{norm_name}_0": norm("encoder.norm"),
         "bottleneck": conv("encoder.conv1x1")}
    blocks = sorted({tuple(map(int, m.groups())) for k in sd if (m := _BLOCK_RE.match(k))})
    for r, i in blocks:
        t = f"separation.sep.{r}.tcn.{i}"
        p[f"tcn_{r}_{i}"] = {
            "conv1x1": conv(f"{t}.conv1x1"),
            "prelu1": {"alpha": sd[f"{t}.prelu1.weight"].reshape(-1)},
            f"{norm_name}_0": norm(f"{t}.norm1"),
            "dwconv": conv(f"{t}.dwconv"),
            "prelu2": {"alpha": sd[f"{t}.prelu2.weight"].reshape(-1)},
            f"{norm_name}_1": norm(f"{t}.norm2"),
            "sconv": conv(f"{t}.sconv"),
        }
    p["mask"] = conv("mask")
    w = sd["decoder.decoder.weight"].transpose(2, 0, 1)[::-1]  # (in, out, k) → (k, in, out)
    p["decoder"] = {"kernel": np.ascontiguousarray(w), "bias": sd["decoder.decoder.bias"]}
    return {"params": p}


def convtasnet_state_dict(params: dict) -> dict:
    """The JAX package's ConvTasNet params (flax layout, numpy;
    ``{"params": {...}}`` or the inner tree) → the port's ``state_dict`` as
    float32 CPU tensors, under the reference's parameter names."""
    p = params.get("params", params)
    gln = "GlobalLayerNorm_0" in p
    norm_name = "GlobalLayerNorm" if gln else "ChannelLayerNorm"
    sd: dict = {}

    def conv(key, node):
        sd[f"{key}.weight"] = np.asarray(node["kernel"]).transpose(2, 1, 0)
        sd[f"{key}.bias"] = np.asarray(node["bias"])

    def norm(key, node):
        if gln:
            sd[f"{key}.gamma"] = np.asarray(node["gamma"]).reshape(-1, 1)
            sd[f"{key}.beta"] = np.asarray(node["beta"]).reshape(-1, 1)
        else:
            sd[f"{key}.weight"] = np.asarray(node["gamma"])
            sd[f"{key}.bias"] = np.asarray(node["beta"])

    conv("encoder.encoder", p["encoder"])
    norm("encoder.norm", p[f"{norm_name}_0"])
    conv("encoder.conv1x1", p["bottleneck"])
    blocks = sorted(tuple(map(int, m.groups())) for k in p if (m := _TCN_RE.match(k)))
    for r, i in blocks:
        node, t = p[f"tcn_{r}_{i}"], f"separation.sep.{r}.tcn.{i}"
        conv(f"{t}.conv1x1", node["conv1x1"])
        sd[f"{t}.prelu1.weight"] = np.asarray(node["prelu1"]["alpha"]).reshape(1)
        norm(f"{t}.norm1", node[f"{norm_name}_0"])
        conv(f"{t}.dwconv", node["dwconv"])
        sd[f"{t}.prelu2.weight"] = np.asarray(node["prelu2"]["alpha"]).reshape(1)
        norm(f"{t}.norm2", node[f"{norm_name}_1"])
        conv(f"{t}.sconv", node["sconv"])
    conv("mask", p["mask"])
    w = np.asarray(p["decoder"]["kernel"])[::-1].transpose(1, 2, 0)  # (k, in, out) → (in, out, k)
    sd["decoder.decoder.weight"] = w
    sd["decoder.decoder.bias"] = np.asarray(p["decoder"]["bias"])
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in sd.items()}


# --- The separation zoo's weights --------------------------------------------
#
# Each model's bridge pair is a spec: a list of (flax path, torch key, kind),
# where a kind is a pair of functions (state dict, torch key) → flax node and
# (flax node, torch key) → torch entries. ``<name>_flax_params`` is the port's
# copy of the JAX package's converter (models/torch_import.py), and
# ``<name>_state_dict`` its inverse, read off the same spec. The layer counts
# each spec needs are read from the keys of the side it starts from.


def _arr(v) -> np.ndarray:
    return np.ascontiguousarray(_np(v))


def _with_bias(out: dict, sd: dict, key: str) -> dict:
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _bias_back(node: dict, key: str, sd: dict) -> dict:
    if "bias" in node:
        sd[f"{key}.bias"] = np.asarray(node["bias"])
    return sd


# Conv1d (O, I, k) ↔ (k, I, O); Linear (O, I) ↔ (I, O); Conv2d (O, I, kh, kw)
# ↔ (kh, kw, I, O); ConvTranspose1d/2d (I, O, k…) ↔ (k…, I, O) with the
# kernel's spatial axes flipped (flax's ConvTranspose does not flip them).
_CONV1D = (
    lambda sd, k: _with_bias({"kernel": _arr(_np(sd[f"{k}.weight"]).transpose(2, 1, 0))}, sd, k),
    lambda n, k: _bias_back(n, k, {f"{k}.weight": np.asarray(n["kernel"]).transpose(2, 1, 0)}))
_LINEAR = (
    lambda sd, k: _with_bias({"kernel": _arr(_np(sd[f"{k}.weight"]).T)}, sd, k),
    lambda n, k: _bias_back(n, k, {f"{k}.weight": np.asarray(n["kernel"]).T}))
_CONV2D = (
    lambda sd, k: _with_bias({"kernel": _arr(_np(sd[f"{k}.weight"]).transpose(2, 3, 1, 0))},
                             sd, k),
    lambda n, k: _bias_back(n, k, {f"{k}.weight": np.asarray(n["kernel"]).transpose(3, 2, 0, 1)}))
_CONVT1D = (
    lambda sd, k: _with_bias({"kernel": _arr(_np(sd[f"{k}.weight"]).transpose(2, 0, 1)[::-1])},
                             sd, k),
    lambda n, k: _bias_back(n, k, {
        f"{k}.weight": np.asarray(n["kernel"])[::-1].transpose(1, 2, 0)}))
_CONVT2D = (
    lambda sd, k: _with_bias(
        {"kernel": _arr(_np(sd[f"{k}.weight"]).transpose(2, 3, 0, 1)[::-1, ::-1])}, sd, k),
    lambda n, k: _bias_back(n, k, {
        f"{k}.weight": np.asarray(n["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)}))
# The zoo's gLN: gamma/beta (C,) ↔ gamma/beta (C,).
_GLN = (
    lambda sd, k: {"gamma": _np(sd[f"{k}.gamma"]).reshape(-1),
                   "beta": _np(sd[f"{k}.beta"]).reshape(-1)},
    lambda n, k: {f"{k}.gamma": np.asarray(n["gamma"]), f"{k}.beta": np.asarray(n["beta"])})
# PReLU weight (n,) ↔ alpha (n,), as a node or (``_PRELU_RAW``) a bare leaf.
_PRELU = (lambda sd, k: {"alpha": _np(sd[f"{k}.weight"]).reshape(-1)},
               lambda n, k: {f"{k}.weight": np.asarray(n["alpha"])})
_PRELU_RAW = (lambda sd, k: _np(sd[f"{k}.weight"]).reshape(-1),
                   lambda n, k: {f"{k}.weight": np.asarray(n)})
# GroupNorm(1)/LayerNorm weight, bias ↔ scale, bias; the zoo's GroupNorm1
# wraps flax's GroupNorm as GroupNorm_0.
_LN = (lambda sd, k: {"scale": _np(sd[f"{k}.weight"]), "bias": _np(sd[f"{k}.bias"])},
            lambda n, k: {f"{k}.weight": np.asarray(n["scale"]),
                          f"{k}.bias": np.asarray(n["bias"])})
_GN = (lambda sd, k: {"GroupNorm_0": _LN[0](sd, k)},
            lambda n, k: _LN[1](n["GroupNorm_0"], k))
# A bare leaf under the same values (``qk_gamma``, ``g``…).
_RAW = (lambda sd, k: _np(sd[k]), lambda n, k: {k: np.asarray(n)})


def _cell_to_flax(sd: dict, key: str, suffix: str) -> dict:
    """One direction of one layer of a torch LSTM (``weight_ih_{suffix}``…)
    → a flax ``OptimizedLSTMCell``: per-gate input denses ``i{g}`` (no bias)
    and hidden denses ``h{g}`` with the bias ``bias_ih + bias_hh``, gates
    ``i f g o`` (torch_import.py:91-113)."""
    w_ih, w_hh = _np(sd[f"{key}.weight_ih_{suffix}"]), _np(sd[f"{key}.weight_hh_{suffix}"])
    b = _np(sd[f"{key}.bias_ih_{suffix}"]) + _np(sd[f"{key}.bias_hh_{suffix}"])
    h = w_hh.shape[1]
    gates = {}
    for i, g in enumerate("ifgo"):
        sl = slice(i * h, (i + 1) * h)
        gates[f"i{g}"] = {"kernel": _arr(w_ih[sl].T)}
        gates[f"h{g}"] = {"kernel": _arr(w_hh[sl].T), "bias": b[sl]}
    return gates


def _cell_to_torch(gates: dict, key: str, suffix: str) -> dict:
    """The inverse: flax's summed bias goes to ``bias_ih``, ``bias_hh`` is
    zero, so flax→torch→flax is exact and torch→flax→torch the same
    function."""
    b = np.concatenate([np.asarray(gates[f"h{g}"]["bias"]) for g in "ifgo"])
    return {f"{key}.weight_ih_{suffix}": np.concatenate(
                [np.asarray(gates[f"i{g}"]["kernel"]).T for g in "ifgo"]),
            f"{key}.weight_hh_{suffix}": np.concatenate(
                [np.asarray(gates[f"h{g}"]["kernel"]).T for g in "ifgo"]),
            f"{key}.bias_ih_{suffix}": b, f"{key}.bias_hh_{suffix}": np.zeros_like(b)}


_DIRECTIONS = (("OptimizedLSTMCell_0", "l0"), ("OptimizedLSTMCell_1", "l0_reverse"))


def _lstm_to_flax(sd: dict, key: str) -> dict:
    """A one-layer torch LSTM → ``OptimizedLSTMCell_0`` (and ``_1``, the
    backward direction, when the layer is bidirectional)."""
    return {cell: _cell_to_flax(sd, key, suffix) for cell, suffix in _DIRECTIONS
            if f"{key}.weight_ih_{suffix}" in sd}


def _lstm_to_torch(node: dict, key: str) -> dict:
    sd = {}
    for cell, suffix in _DIRECTIONS:
        if cell in node:
            sd.update(_cell_to_torch(node[cell], key, suffix))
    return sd


_LSTM = (_lstm_to_flax, _lstm_to_torch)
# One cell ↔ a one-layer unidirectional torch LSTM (DCCRN's complex LSTM
# keeps its real and imaginary LSTMs as cells 0 and 1 of one flax node).
_CELL = (lambda sd, k: _cell_to_flax(sd, k, "l0"),
         lambda n, k: _cell_to_torch(n, k, "l0"))
# A stack of unidirectional layers (the enhancement models' SequenceModel):
# layer i ↔ ``OptimizedLSTMCell_i``.
_LSTM_STACK = (
    lambda sd, k: {f"OptimizedLSTMCell_{i}": _cell_to_flax(sd, k, f"l{i}")
                   for i in _ids(sd, rf"^{re.escape(k)}\.weight_ih_l(\d+)$")},
    lambda n, k: {t: v for i in _ids(n, r"^OptimizedLSTMCell_(\d+)$")
                  for t, v in _cell_to_torch(n[f"OptimizedLSTMCell_{i}"], k, f"l{i}").items()})


def _mha_to_flax(sd: dict, key: str, heads: int) -> dict:
    """``nn.MultiheadAttention`` → flax ``MultiHeadDotProductAttention``
    (torch_import.py:1071-1097)."""
    w, b = _np(sd[f"{key}.in_proj_weight"]), _np(sd[f"{key}.in_proj_bias"])
    c = w.shape[1]
    hd = c // heads

    def proj(i):
        return {"kernel": _arr(w[i * c:(i + 1) * c].T.reshape(c, heads, hd)),
                "bias": b[i * c:(i + 1) * c].reshape(heads, hd)}

    return {"query": proj(0), "key": proj(1), "value": proj(2),
            "out": {"kernel": _arr(_np(sd[f"{key}.out_proj.weight"]).T.reshape(heads, hd, c)),
                    "bias": _np(sd[f"{key}.out_proj.bias"])}}


def _mha_to_torch(node: dict, key: str) -> dict:
    c = np.asarray(node["out"]["bias"]).shape[0]
    return {
        f"{key}.in_proj_weight": np.concatenate(
            [np.asarray(node[n]["kernel"]).reshape(c, c).T for n in ("query", "key", "value")]),
        f"{key}.in_proj_bias": np.concatenate(
            [np.asarray(node[n]["bias"]).reshape(c) for n in ("query", "key", "value")]),
        f"{key}.out_proj.weight": np.asarray(node["out"]["kernel"]).reshape(c, c).T,
        f"{key}.out_proj.bias": np.asarray(node["out"]["bias"]),
    }


def _mha(heads: int):
    return (lambda sd, k: _mha_to_flax(sd, k, heads), _mha_to_torch)


def _put(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def _get(tree: dict, path: str):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def _flat_keys(tree: dict, prefix: str = "") -> list[str]:
    out = []
    for k, v in tree.items():
        out += _flat_keys(v, f"{prefix}{k}/") if isinstance(v, dict) else [prefix + k]
    return out


def _ids(keys, pattern: str) -> list[int]:
    """The distinct integers that ``pattern``'s first group matches in ``keys``."""
    rx = re.compile(pattern)
    return sorted({int(m.group(1)) for k in keys if (m := rx.search(k))})


def _spec_to_flax(state_dict: dict, spec: list) -> dict:
    sd = dict(state_dict)
    p: dict = {}
    for fpath, tkey, kind in spec:
        _put(p, fpath, kind[0](sd, tkey))
    return {"params": p}


def _spec_to_torch(params: dict, spec: list) -> dict:
    p = params.get("params", params)
    sd: dict = {}
    for fpath, tkey, kind in spec:
        sd.update(kind[1](_get(p, fpath), tkey))
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in sd.items()}


def _flat(params: dict) -> list[str]:
    """The leaf paths of a flax tree, ``/``-joined, below ``params``."""
    return _flat_keys(params.get("params", params))


def _dprnn_spec(layers) -> list:
    """DPRNN-TasNet (torch_import.py:165-190)."""
    s = "separation"
    spec = [("encoder", "encoder.conv1d", _CONV1D), ("GroupNorm1_0", f"{s}.norm", _GN),
            ("bottleneck", f"{s}.conv1d", _CONV1D), ("mask_conv2d", f"{s}.conv2d", _CONV2D),
            ("end_conv1x1", f"{s}.end_conv1x1", _CONV1D), ("output", f"{s}.output.0", _CONV1D),
            ("output_gate", f"{s}.output_gate.0", _CONV1D), ("prelu", f"{s}.prelu", _PRELU),
            ("decoder", "decoder", _CONVT1D)]
    for i in layers:
        f, t = f"dual_rnn_{i}", f"{s}.dual_rnn.{i}"
        spec += [(f"{f}/LSTMLayer_0", f"{t}.intra_rnn", _LSTM),
                 (f"{f}/Dense_0", f"{t}.intra_linear", _LINEAR),
                 (f"{f}/GroupNorm1_0", f"{t}.intra_norm", _GN),
                 (f"{f}/LSTMLayer_1", f"{t}.inter_rnn", _LSTM),
                 (f"{f}/Dense_1", f"{t}.inter_linear", _LINEAR),
                 (f"{f}/GroupNorm1_1", f"{t}.inter_norm", _GN)]
    return spec


def dprnn_flax_params(state_dict: dict) -> dict:
    """The port's (or the reference's) DPRNN-TasNet ``state_dict`` → the JAX
    package's flax params ``{"params": {...}}`` as numpy arrays."""
    return _spec_to_flax(state_dict, _dprnn_spec(
        _ids(state_dict, r"^separation\.dual_rnn\.(\d+)\.")))


def dprnn_state_dict(params: dict) -> dict:
    """The JAX package's DPRNN-TasNet params → the port's ``state_dict``."""
    return _spec_to_torch(params, _dprnn_spec(_ids(_flat(params), r"^dual_rnn_(\d+)/")))


def _cn(f: str, t: str, act: bool = False) -> list:
    """The zoo's ConvNorm(Act): ``Conv_0``, ``GlobalLayerNorm_0`` (and
    ``PReLU_0``) ↔ ``conv``, ``norm`` (and ``act``)."""
    return ([(f"{f}/Conv_0", f"{t}.conv", _CONV1D), (f"{f}/GlobalLayerNorm_0", f"{t}.norm", _GLN)]
            + ([(f"{f}/PReLU_0", f"{t}.act", _PRELU)] if act else []))


def _masked_decoder_spec() -> list:
    return [("encoder", "encoder", _CONV1D), ("ln", "ln", _GLN),
            ("bottleneck", "bottleneck", _CONV1D), ("mask_prelu", "mask_net.0", _PRELU),
            ("mask_conv", "mask_net.1", _CONV1D), ("decoder", "decoder", _CONVT1D)]


def _sudormrf_spec(blocks, depths) -> list:
    """SuDORMRF (torch_import.py:217-249)."""
    spec = _masked_decoder_spec()
    for i in blocks:
        f, t = f"sm_{i}", f"sm.{i}"
        spec += _cn(f"{f}/proj_1x1", f"{t}.proj_1x1", act=True) + [
            (f"{f}/final_norm/GlobalLayerNorm_0", f"{t}.final_norm.norm", _GLN),
            (f"{f}/final_norm/PReLU_0", f"{t}.final_norm.act", _PRELU),
            (f"{f}/res_conv", f"{t}.res_conv", _CONV1D)]
        for k in depths:
            spec += _cn(f"{f}/spp_{k}", f"{t}.spp_dw.{k}")
    return spec


def sudormrf_flax_params(state_dict: dict) -> dict:
    """SuDORMRF's ``state_dict`` → the JAX package's flax params."""
    return _spec_to_flax(state_dict, _sudormrf_spec(
        _ids(state_dict, r"^sm\.(\d+)\."), _ids(state_dict, r"^sm\.0\.spp_dw\.(\d+)\.")))


def sudormrf_state_dict(params: dict) -> dict:
    """The JAX package's SuDORMRF params → the port's ``state_dict``."""
    keys = _flat(params)
    return _spec_to_torch(params, _sudormrf_spec(_ids(keys, r"^sm_(\d+)/"),
                                                 _ids(keys, r"^sm_0/spp_(\d+)/")))


def _afrcnn_spec(depths) -> list:
    """AFRCNN (torch_import.py:252-291): one shared block at ``sm.blocks``."""
    b = "sm.blocks"
    spec = _masked_decoder_spec() + [
        ("concat_conv", "sm.concat_block.0", _CONV1D),
        ("concat_prelu", "sm.concat_block.1", _PRELU),
        ("blocks/res_conv", f"{b}.res_conv", _CONV1D)]
    spec += _cn("blocks/proj_1x1", f"{b}.proj_1x1", act=True)
    spec += _cn("blocks/last_layer", f"{b}.last_layer.0", act=True)
    for k in depths:
        spec += _cn(f"blocks/spp_{k}", f"{b}.spp_dw.{k}")
        spec += _cn(f"blocks/concat_{k}", f"{b}.concat_layer.{k}", act=True)
        if k >= 1:
            spec += _cn(f"blocks/fuse_{k}_down", f"{b}.fuse_layers.{k}.0")
    return spec


def afrcnn_flax_params(state_dict: dict) -> dict:
    """AFRCNN's ``state_dict`` → the JAX package's flax params."""
    return _spec_to_flax(state_dict, _afrcnn_spec(
        _ids(state_dict, r"^sm\.blocks\.spp_dw\.(\d+)\.")))


def afrcnn_state_dict(params: dict) -> dict:
    """The JAX package's AFRCNN params → the port's ``state_dict``."""
    return _spec_to_torch(params, _afrcnn_spec(_ids(_flat(params), r"^blocks/spp_(\d+)/")))


def _vproj_to_torch(node: dict, key: str) -> dict:
    """TDANet's batch-axis attention keeps the value rows of
    ``in_proj_weight`` alone; the query and key rows, which it never uses,
    come back as zeros."""
    w, b = np.asarray(node["kernel"]).T, np.asarray(node["bias"])
    return {f"{key}.in_proj_weight": np.concatenate([np.zeros((2 * w.shape[0], w.shape[1]),
                                                              w.dtype), w]),
            f"{key}.in_proj_bias": np.concatenate([np.zeros(2 * b.shape[0], b.dtype), b])}


def _vproj_to_flax(sd: dict, key: str) -> dict:
    w, b = _np(sd[f"{key}.in_proj_weight"]), _np(sd[f"{key}.in_proj_bias"])
    c = w.shape[1]
    return {"kernel": _arr(w[2 * c:3 * c].T), "bias": b[2 * c:3 * c]}


_VPROJ = (_vproj_to_flax, _vproj_to_torch)


def _tdanet_spec(depths, torch_compat: bool) -> list:
    """TDANet (torch_import.py:294-366), in either mode: the reference quirk
    (``torch_compat``: ``v_proj`` and ``out_proj``) or the temporal
    attention (``attn``, 8 heads)."""
    u, ga = "sm.unet", "sm.unet.globalatt"
    spec = _masked_decoder_spec() + [
        ("concat_conv", "sm.concat_block.0", _CONV1D),
        ("concat_prelu", "sm.concat_block.1", _PRELU),
        ("unet/res_conv", f"{u}.res_conv", _CONV1D),
        ("unet/globalatt/attn_in_norm", f"{ga}.attn.attn_in_norm", _LN),
        ("unet/globalatt/attn_norm", f"{ga}.attn.norm", _LN),
        ("unet/globalatt/mlp_dwconv", f"{ga}.mlp.dwconv", _CONV1D)]
    if torch_compat:
        spec += [("unet/globalatt/v_proj", f"{ga}.attn.attn", _VPROJ),
                 ("unet/globalatt/out_proj", f"{ga}.attn.attn.out_proj", _LINEAR)]
    else:
        spec += [("unet/globalatt/attn", f"{ga}.attn.attn", _mha(8))]
    spec += _cn("unet/proj_1x1", f"{u}.proj_1x1", act=True)
    spec += _cn("unet/globalatt/mlp_fc1", f"{ga}.mlp.fc1") + _cn("unet/globalatt/mlp_fc2",
                                                                 f"{ga}.mlp.fc2")
    for k in depths:
        spec += _cn(f"unet/spp_{k}", f"{u}.spp_dw.{k}")
        for part in ("local_embedding", "global_act"):
            spec += _cn(f"unet/loc_glo_fus_{k}/{part}", f"{u}.loc_glo_fus.{k}.{part}")
    for i in depths[:-1]:
        for part in ("local_embedding", "global_embedding", "global_act"):
            spec += _cn(f"unet/last_layer_{i}/{part}", f"{u}.last_layer.{i}.{part}")
    return spec


def tdanet_flax_params(state_dict: dict, torch_compat: bool = False) -> dict:
    """TDANet's ``state_dict`` → the JAX package's flax params for a model
    of mode ``torch_compat`` (the JAX converter's, for reference
    checkpoints, is ``torch_compat=True``)."""
    return _spec_to_flax(state_dict, _tdanet_spec(
        _ids(state_dict, r"^sm\.unet\.spp_dw\.(\d+)\."), torch_compat))


def tdanet_state_dict(params: dict) -> dict:
    """The JAX package's TDANet params, of either mode (read from the
    tree), → the port's ``state_dict``."""
    keys = _flat(params)
    return _spec_to_torch(params, _tdanet_spec(
        _ids(keys, r"^unet/spp_(\d+)/"), any(k.startswith("unet/globalatt/v_proj/")
                                             for k in keys)))


# DPTNet's gLN: gamma/beta (1, C, 1) ↔ GroupNorm_0 scale/bias (C,).
_DPGN = (
    lambda sd, k: {"GroupNorm_0": {"scale": _np(sd[f"{k}.gamma"]).reshape(-1),
                                   "bias": _np(sd[f"{k}.beta"]).reshape(-1)}},
    lambda n, k: {f"{k}.gamma": np.asarray(n["GroupNorm_0"]["scale"]).reshape(1, -1, 1),
                  f"{k}.beta": np.asarray(n["GroupNorm_0"]["bias"]).reshape(1, -1, 1)})


def _dptnet_spec(layers, att_heads: int) -> list:
    """DPTNetModel (torch_import.py:1098-1167)."""
    core = "separator.dptnet"
    spec = [("encoder", "encoder.conv1d", _CONV1D), ("enc_LN", "separator.enc_LN", _DPGN),
            ("out_prelu", f"{core}.output.0", _PRELU), ("out_conv", f"{core}.output.1", _CONV2D),
            ("output", "separator.output.0", _CONV1D),
            ("output_gate", "separator.output_gate.0", _CONV1D),
            ("decoder", "decoder.convtrans1d", _CONVT1D)]
    for i in layers:
        for side in ("row", "col"):
            f, t = f"{side}_transformer_{i}", f"{core}.{side}_transformer.{i}"
            spec += [(f"{f}/self_attn", f"{t}.self_attn", _mha(att_heads)),
                     (f"{f}/norm_attn", f"{t}.norm_attn", _DPGN), (f"{f}/rnn", f"{t}.rnn", _LSTM),
                     (f"{f}/ff_linear", f"{t}.feed_forward.2", _LINEAR),
                     (f"{f}/norm_ff", f"{t}.norm_ff", _DPGN)]
    return spec


def dptnet_flax_params(state_dict: dict, att_heads: int = 4) -> dict:
    """DPTNetModel's ``state_dict`` → the JAX package's flax params; the
    attention's denses are split into ``att_heads`` heads."""
    return _spec_to_flax(state_dict, _dptnet_spec(
        _ids(state_dict, r"^separator\.dptnet\.row_transformer\.(\d+)\."), att_heads))


def dptnet_state_dict(params: dict) -> dict:
    """The JAX package's DPTNetModel params → the port's ``state_dict``."""
    return _spec_to_torch(params, _dptnet_spec(_ids(_flat(params), r"^row_transformer_(\d+)/"), 1))


def _bsrnn_spec(bands, repeats) -> list:
    """BSRNN (torch_import.py:369-404)."""
    spec = []
    for i in bands:
        spec += [(f"bn_norm_{i}", f"BN.{i}.0", _GN), (f"bn_conv_{i}", f"BN.{i}.1", _CONV1D),
                 (f"mask_norm_{i}", f"mask.{i}.0", _GN), (f"mask_c1_{i}", f"mask.{i}.1", _CONV1D),
                 (f"mask_c2_{i}", f"mask.{i}.3", _CONV1D), (f"mask_c3_{i}", f"mask.{i}.5", _CONV1D)]
    for r in repeats:
        for part in ("band_rnn", "band_comm"):
            f, t = f"bsnet_{r}/{part}", f"separator.{r}.{part}"
            spec += [(f"{f}/GroupNorm1_0", f"{t}.norm", _GN),
                     (f"{f}/LSTMLayer_0", f"{t}.rnn", _LSTM),
                     (f"{f}/Dense_0", f"{t}.proj", _LINEAR)]
    return spec


def bsrnn_flax_params(state_dict: dict) -> dict:
    """BSRNN's ``state_dict`` → the JAX package's flax params."""
    return _spec_to_flax(state_dict, _bsrnn_spec(_ids(state_dict, r"^BN\.(\d+)\."),
                                                 _ids(state_dict, r"^separator\.(\d+)\.")))


def bsrnn_state_dict(params: dict) -> dict:
    """The JAX package's BSRNN params → the port's ``state_dict``."""
    keys = _flat(params)
    return _spec_to_torch(params, _bsrnn_spec(_ids(keys, r"^bn_conv_(\d+)/"),
                                              _ids(keys, r"^bsnet_(\d+)/")))


# TF-GridNet: the sub-band projection is a Linear where the unfold's kernel
# equals its hop, else a ConvTranspose1d (read from the weight's rank); the
# all-head norm's per-head PReLU slope (H,) ↔ (H, 1, 1, 1); the concat norm's
# gamma/beta (1, C, 1, F) ↔ channel-last (1, 1, F, C).
_SUBLINEAR = (
    lambda sd, k: (_LINEAR if _np(sd[f"{k}.weight"]).ndim == 2 else _CONVT1D)[0](sd, k),
    lambda n, k: (_LINEAR if np.asarray(n["kernel"]).ndim == 2 else _CONVT1D)[1](n, k))
_AHLN = (
    lambda sd, k: {"gamma": _np(sd[f"{k}.gamma"]), "beta": _np(sd[f"{k}.beta"]),
                   "prelu_alpha": _np(sd[f"{k}.act.weight"]).reshape(-1, 1, 1, 1)},
    lambda n, k: {f"{k}.gamma": np.asarray(n["gamma"]), f"{k}.beta": np.asarray(n["beta"]),
                  f"{k}.act.weight": np.asarray(n["prelu_alpha"]).reshape(-1)})
_LN4D = (
    lambda sd, k: {"gamma": _arr(_np(sd[f"{k}.gamma"]).transpose(0, 2, 3, 1)),
                   "beta": _arr(_np(sd[f"{k}.beta"]).transpose(0, 2, 3, 1))},
    lambda n, k: {f"{k}.gamma": np.asarray(n["gamma"]).transpose(0, 3, 1, 2),
                  f"{k}.beta": np.asarray(n["beta"]).transpose(0, 3, 1, 2)})


def _tfgridnet_spec(layers) -> list:
    """TFGridNet (torch_import.py:754-808)."""
    spec = [("conv", "conv.0", _CONV2D), ("conv_norm", "conv.1", _LN),
            ("deconv", "deconv", _CONVT2D)]
    for i in layers:
        f, t = f"block_{i}", f"blocks.{i}"
        for part in ("intra", "inter"):
            spec += [(f"{f}/{part}_norm", f"{t}.{part}_norm", _LN),
                     (f"{f}/{part}_rnn", f"{t}.{part}_rnn", _LSTM),
                     (f"{f}/{part}_linear", f"{t}.{part}_linear", _SUBLINEAR)]
        for q in "QKV":
            spec += [(f"{f}/attn_conv_{q}", f"{t}.attn_conv_{q}", _CONV2D),
                     (f"{f}/attn_norm_{q}", f"{t}.attn_norm_{q}", _AHLN)]
        spec += [(f"{f}/attn_concat_conv", f"{t}.attn_concat_proj.0", _CONV2D),
                 (f"{f}/attn_prelu", f"{t}.attn_concat_proj.1", _PRELU_RAW),
                 (f"{f}/attn_concat_norm", f"{t}.attn_concat_proj.2", _LN4D)]
    return spec


def tfgridnet_flax_params(state_dict: dict) -> dict:
    """TFGridNet's ``state_dict`` → the JAX package's flax params."""
    return _spec_to_flax(state_dict, _tfgridnet_spec(_ids(state_dict, r"^blocks\.(\d+)\.")))


def tfgridnet_state_dict(params: dict) -> dict:
    """The JAX package's TFGridNet params → the port's ``state_dict``."""
    return _spec_to_torch(params, _tfgridnet_spec(_ids(_flat(params), r"^block_(\d+)/")))


# MossFormer(2). The ScaleNorm gain, the positional scale and the FLASH
# offset-scale are bare leaves under the same values; cLN weight/bias ↔
# gamma/beta; the FSMN memory conv, a Conv2d (C, i + 1, k, 1), ↔ (k, i + 1, C).
_CLN = (lambda sd, k: {"gamma": _np(sd[f"{k}.weight"]), "beta": _np(sd[f"{k}.bias"])},
             lambda n, k: {f"{k}.weight": np.asarray(n["gamma"]),
                           f"{k}.bias": np.asarray(n["beta"])})
_FSMN_CONV = (
    lambda sd, k: {"kernel": _arr(_np(sd[f"{k}.weight"])[..., 0].transpose(2, 1, 0))},
    lambda n, k: {f"{k}.weight": np.asarray(n["kernel"]).transpose(2, 1, 0)[..., None]})


def _ffconvm_spec(f: str, t: str, scalenorm: bool = True) -> list:
    """FFConvM (mossformer_block.py:89-103): norm, linear, depthwise conv."""
    norm = ((f"{f}/norm/g", f"{t}.mdl.0.g", _RAW) if scalenorm
            else (f"{f}/norm", f"{t}.mdl.0", _LN))
    return [norm, (f"{f}/linear", f"{t}.mdl.1", _LINEAR),
            (f"{f}/conv/dwconv", f"{t}.mdl.3.sequential.1.conv", _CONV1D)]


def _mossformer_spec(blocks, v2: bool) -> list:
    """MossFormer (torch_import.py:1170-1195) and MossFormer2's v2 tree
    (:1238-1268)."""
    mn = "mask_net"
    core = f"{mn}.mdl.intra_mdl" if v2 else f"{mn}.mdl.att_mdl"
    spec = [("encoder", ("enc" if v2 else "encoder") + ".conv1d", _CONV1D),
            ("masknet_norm", f"{mn}.norm", _GN),
            ("conv1d_encoder", f"{mn}.conv1d_encoder", _CONV1D),
            ("pos_enc/scale", f"{mn}.pos_enc.scale", _RAW),
            ("att_final_norm", f"{core}.norm" + ("" if v2 else ".norm"), _LN),
            ("att_norm", f"{mn}.mdl." + ("intra_norm" if v2 else "att_norm"), _GN),
            ("prelu", f"{mn}.prelu", _PRELU), ("conv1d_out", f"{mn}.conv1d_out", _CONV1D),
            ("output", f"{mn}.output.0", _CONV1D), ("output_gate", f"{mn}.output_gate.0", _CONV1D),
            ("conv1_decoder", f"{mn}.conv1_decoder", _CONV1D),
            ("decoder", "dec" if v2 else "decoder", _CONVT1D)]
    for i in blocks:
        f, t = f"flash_{i}", f"{core}.mossformerM.layers.{i}"
        for part in ("to_hidden", "to_qk", "to_out"):
            spec += _ffconvm_spec(f"{f}/{part}", f"{t}.{part}")
        spec += [(f"{f}/qk_gamma", f"{t}.qk_offset_scale.gamma", _RAW),
                 (f"{f}/qk_beta", f"{t}.qk_offset_scale.beta", _RAW)]
        if not v2:
            continue
        f, t = f"fsmn_{i}", f"{core}.mossformerM.fsmn.{i}"
        g = f"{t}.gated_fsmn"
        spec += [(f"{f}/conv1", f"{t}.conv1.0", _CONV1D),
                 (f"{f}/conv1_prelu", f"{t}.conv1.1", _PRELU),
                 (f"{f}/norm1", f"{t}.norm1", _CLN), (f"{f}/norm2", f"{t}.norm2", _CLN),
                 (f"{f}/conv2", f"{t}.conv2", _CONV1D),
                 (f"{f}/fsmn/linear", f"{g}.fsmn.linear", _LINEAR),
                 (f"{f}/fsmn/project", f"{g}.fsmn.project", _LINEAR)]
        spec += _ffconvm_spec(f"{f}/to_u", f"{g}.to_u", False)
        spec += _ffconvm_spec(f"{f}/to_v", f"{g}.to_v", False)
        for d in range(2):  # the FSMN memory's depth (fsmn.py:114-143)
            c, tc = f"{f}/fsmn/conv", f"{g}.fsmn.conv"
            spec += [(f"{c}/conv_{d}", f"{tc}.conv{d + 1}", _FSMN_CONV),
                     (f"{c}/in_gamma_{d}", f"{tc}.norm{d + 1}.weight", _RAW),
                     (f"{c}/in_beta_{d}", f"{tc}.norm{d + 1}.bias", _RAW),
                     (f"{c}/prelu_{d}", f"{tc}.prelu{d + 1}.weight", _RAW)]
    return spec


def mossformer_flax_params(state_dict: dict) -> dict:
    """MossFormer's ``state_dict`` → the JAX package's flax params."""
    return _spec_to_flax(state_dict, _mossformer_spec(
        _ids(state_dict, r"\.mossformerM\.layers\.(\d+)\."), v2=False))


def mossformer_state_dict(params: dict) -> dict:
    """The JAX package's MossFormer params → the port's ``state_dict``."""
    return _spec_to_torch(params, _mossformer_spec(_ids(_flat(params), r"^flash_(\d+)/"), False))


def mossformer2_flax_params(state_dict: dict) -> dict:
    """MossFormer2's ``state_dict`` → the JAX package's flax params."""
    return _spec_to_flax(state_dict, _mossformer_spec(
        _ids(state_dict, r"\.mossformerM\.layers\.(\d+)\."), v2=True))


def mossformer2_state_dict(params: dict) -> dict:
    """The JAX package's MossFormer2 params → the port's ``state_dict``."""
    return _spec_to_torch(params, _mossformer_spec(_ids(_flat(params), r"^flash_(\d+)/"), True))


# SkiM: the reference's norms keep gamma/beta (1, C, 1); the JAX model reads
# them as GroupNorm1's scale/bias (non-causal) or ChannelLayerNorm's
# gamma/beta (causal).
_SKIM_GLN = (
    lambda sd, k: {"GroupNorm_0": {"scale": _np(sd[f"{k}.gamma"]).reshape(-1),
                                   "bias": _np(sd[f"{k}.beta"]).reshape(-1)}},
    lambda n, k: {f"{k}.gamma": np.asarray(n["GroupNorm_0"]["scale"]).reshape(1, -1, 1),
                  f"{k}.beta": np.asarray(n["GroupNorm_0"]["bias"]).reshape(1, -1, 1)})
_SKIM_CLN = (
    lambda sd, k: {"gamma": _np(sd[f"{k}.gamma"]).reshape(-1),
                   "beta": _np(sd[f"{k}.beta"]).reshape(-1)},
    lambda n, k: {f"{k}.gamma": np.asarray(n["gamma"]).reshape(1, -1, 1),
                  f"{k}.beta": np.asarray(n["beta"]).reshape(1, -1, 1)})


def _skim_spec(layers, mems: dict, causal: bool) -> list:
    """SkiMNet (torch_import.py:988-1032); ``mems`` maps a Mem-LSTM's index
    to the states it refines ("h", "c")."""
    sep, norm = "separation.skim", _SKIM_CLN if causal else _SKIM_GLN
    spec = [("encoder", "encoder.conv1d", _CONV1D), ("out_prelu", f"{sep}.output_fc.0", _PRELU),
            ("output_fc", f"{sep}.output_fc.1", _CONV1D), ("decoder", "decoder", _CONVT1D)]
    for i in layers:
        f, t = f"seg_lstm_{i}", f"{sep}.seg_lstms.{i}"
        spec += [(f, f"{t}.lstm", _LSTM), (f"{f}/proj", f"{t}.proj", _LINEAR),
                 (f"{f}/norm", f"{t}.norm", norm)]
    for i, tags in mems.items():
        f, t = f"mem_lstm_{i}", f"{sep}.mem_lstms.{i}"
        for tag in tags:
            spec += [(f"{f}/{tag}_net/LSTMLayer_0", f"{t}.{tag}_net.rnn", _LSTM),
                     (f"{f}/{tag}_net/proj", f"{t}.{tag}_net.proj", _LINEAR),
                     (f"{f}/{tag}_norm", f"{t}.{tag}_norm", norm)]
    return spec


def _mems(keys, pattern: str) -> dict:
    rx = re.compile(pattern)
    out: dict = {}
    for k in keys:
        if m := rx.search(k):
            out.setdefault(int(m.group(1)), set()).add(m.group(2))
    return {i: sorted(tags, reverse=True) for i, tags in sorted(out.items())}


def skim_flax_params(state_dict: dict) -> dict:
    """SkiMNet's ``state_dict`` → the JAX package's flax params (causal when
    the SegLSTMs have no backward direction)."""
    causal = "separation.skim.seg_lstms.0.lstm.weight_ih_l0_reverse" not in state_dict
    return _spec_to_flax(state_dict, _skim_spec(
        _ids(state_dict, r"^separation\.skim\.seg_lstms\.(\d+)\."),
        _mems(state_dict, r"^separation\.skim\.mem_lstms\.(\d+)\.([hc])_net\."), causal))


def skim_state_dict(params: dict) -> dict:
    """The JAX package's SkiMNet params → the port's ``state_dict``."""
    keys = _flat(params)
    return _spec_to_torch(params, _skim_spec(
        _ids(keys, r"^seg_lstm_(\d+)/"), _mems(keys, r"^mem_lstm_(\d+)/([hc])_net/"),
        any(k.startswith("seg_lstm_0/norm/gamma") for k in keys)))


# --- The enhancement zoo's weights -------------------------------------------
#
# StatelessBatchNorm: scale, bias (and the frozen mean, var) ↔ weight, bias
# (and running_mean, running_var). FRCRN's FSMN memory: a depthwise Conv2d
# (C, 1, lorder, 1) ↔ (lorder, 1, C).
_BN = (
    lambda sd, k: {n: _np(sd[f"{k}.{t}"]) for n, t in _BN_NAMES if f"{k}.{t}" in sd},
    lambda n, k: {f"{k}.{t}": np.asarray(n[f]) for f, t in _BN_NAMES if f in n})
_BN_NAMES = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
             ("var", "running_var"))
_FSMN_MEMORY = (
    lambda sd, k: {"kernel": _arr(_np(sd[f"{k}.weight"])[:, 0, :, 0].T[:, None, :])},
    lambda n, k: {f"{k}.weight": np.asarray(n["kernel"])[:, 0, :].T[:, None, :, None]})


def _seq_model(f: str, t: str, fc: bool = True) -> list:
    """SequenceModel (torch_import.py:476-486): ``sequence_model`` and
    ``fc_output_layer``."""
    return ([(f, f"{t}.sequence_model", _LSTM_STACK)]
            + ([(f"{f}/fc_output", f"{t}.fc_output_layer", _LINEAR)] if fc else []))


def fullband_flax_params(state_dict: dict) -> dict:
    """Fullband's ``state_dict`` → the JAX package's flax params
    (torch_import.py:488)."""
    return _spec_to_flax(state_dict, _seq_model("fullband_model", "fullband_model"))


def fullband_state_dict(params: dict) -> dict:
    """The JAX package's Fullband params → the port's ``state_dict``."""
    return _spec_to_torch(params, _seq_model("fullband_model", "fullband_model"))


_FULLSUBNET = _seq_model("fb_model", "fb_model") + _seq_model("sb_model", "sb_model")


def fullsubnet_flax_params(state_dict: dict) -> dict:
    """FullSubnet's ``state_dict`` → the JAX package's flax params
    (torch_import.py:494)."""
    return _spec_to_flax(state_dict, _FULLSUBNET)


def fullsubnet_state_dict(params: dict) -> dict:
    """The JAX package's FullSubnet params → the port's ``state_dict``."""
    return _spec_to_torch(params, _FULLSUBNET)


_FASTFULLSUBNET = (_seq_model("encoder_0", "encoder.0", False) + _seq_model("encoder_1", "encoder.1")
                   + _seq_model("bottleneck", "bottleneck")
                   + _seq_model("decoder_0", "decoder_lstm.0", False)
                   + _seq_model("decoder_1", "decoder_lstm.1"))


def fastfullsubnet_flax_params(state_dict: dict) -> dict:
    """FastFullSubnet's ``state_dict`` → the JAX package's flax params
    (torch_import.py:661)."""
    return _spec_to_flax(state_dict, _FASTFULLSUBNET)


def fastfullsubnet_state_dict(params: dict) -> dict:
    """The JAX package's FastFullSubnet params → the port's ``state_dict``."""
    return _spec_to_torch(params, _FASTFULLSUBNET)


def _fullsubnet_plus_spec() -> list:
    """FullSubNet_Plus (torch_import.py:668-708)."""
    spec = []
    for f, part in (("fb", ""), ("fbr", "_real"), ("fbi", "_imag")):
        se, tcn = f"channel_attention{part}", f"fb_model{part}"
        spec += [(f"{f}_se/fc1", f"{se}.fc1", _LINEAR), (f"{f}_se/fc2", f"{se}.fc2", _LINEAR),
                 (f"{f}_tcn/fc_output", f"{tcn}.fc_output_layer", _LINEAR)]
        for i in range(8):
            b, t = f"{f}_tcn/tcn_{i}", f"{tcn}.sequence_model.{i}"
            spec += [(f"{b}/conv1x1", f"{t}.conv1x1", _CONV1D),
                     (f"{b}/prelu1", f"{t}.prelu1", _PRELU), (f"{b}/norm1", f"{t}.norm1", _GN),
                     (f"{b}/depthwise", f"{t}.depthwise_conv", _CONV1D),
                     (f"{b}/prelu2", f"{t}.prelu2", _PRELU), (f"{b}/norm2", f"{t}.norm2", _GN),
                     (f"{b}/sconv", f"{t}.sconv", _CONV1D)]
    return spec + _seq_model("sb_model", "sb_model")


def fullsubnet_plus_flax_params(state_dict: dict) -> dict:
    """FullSubNet_Plus's ``state_dict`` → the JAX package's flax params."""
    return _spec_to_flax(state_dict, _fullsubnet_plus_spec())


def fullsubnet_plus_state_dict(params: dict) -> dict:
    """The JAX package's FullSubNet_Plus params → the port's ``state_dict``."""
    return _spec_to_torch(params, _fullsubnet_plus_spec())


def _inter_subnet_spec() -> list:
    """Inter_SubNet (torch_import.py:711-735)."""
    spec = [("fc_output", "sb_model.fc_output_layer", _LINEAR)]
    for i in range(2):
        f, t = f"sil_{i}", f"sb_model.sequence_list.{i}"
        spec += [(f"{f}/OptimizedLSTMCell_0", f"{t}.RNN", _CELL), (f"{f}/norm", f"{t}.norm", _GN),
                 (f"{f}/subinter/norm", f"{t}.SubInter.norm", _GN)]
        for name, prelu, tkey in (("input_linear", "in_prelu", "input_linear"),
                                  ("mean_linear", "mean_prelu", "mean_linear"),
                                  ("output_linear", "out_prelu", "output_linear")):
            spec += [(f"{f}/subinter/{name}", f"{t}.SubInter.{tkey}.0", _LINEAR),
                     (f"{f}/subinter/{prelu}", f"{t}.SubInter.{tkey}.1", _PRELU)]
    return spec


def inter_subnet_flax_params(state_dict: dict) -> dict:
    """Inter_SubNet's ``state_dict`` → the JAX package's flax params."""
    return _spec_to_flax(state_dict, _inter_subnet_spec())


def inter_subnet_state_dict(params: dict) -> dict:
    """The JAX package's Inter_SubNet params → the port's ``state_dict``."""
    return _spec_to_torch(params, _inter_subnet_spec())


def _dccrn_spec(enc, rnn, projected) -> list:
    """DCCRN (torch_import.py:430-474) but its BatchNorms (``_dccrn_bns``)."""
    n = len(enc)
    spec = []
    for i in enc:
        for part in ("real_conv", "imag_conv"):
            spec += [(f"enc_{i}/{part}", f"encoder.{i}.0.{part}", _CONV2D),
                     (f"dec_{i}/{part}", f"decoder.{i}.0.{part}", _CONVT2D)]
        spec.append((f"enc_prelu_{i}", f"encoder.{i}.2", _PRELU_RAW))
        if i < n - 1:
            spec.append((f"dec_prelu_{i}", f"decoder.{i}.2", _PRELU_RAW))
    for li in rnn:
        f, t = f"clstm_{li}", f"enhance.{li}"
        spec += [(f"{f}/OptimizedLSTMCell_0", f"{t}.real_lstm", _CELL),
                 (f"{f}/OptimizedLSTMCell_1", f"{t}.imag_lstm", _CELL)]
        if li in projected:
            spec += [(f"{f}/r_trans", f"{t}.r_trans", _LINEAR),
                     (f"{f}/i_trans", f"{t}.i_trans", _LINEAR)]
    return spec


def _dccrn_bns(n: int):
    """DCCRN's BatchNorms: the torch key over [real; imag] channels and the
    flax nodes of its two halves (``batchnorm_halves``, torch_import.py:417)."""
    for i in range(n):
        yield f"encoder.{i}.1", f"enc_bn_{i}", f"enc_bni_{i}"
        if i < n - 1:
            yield f"decoder.{i}.1", f"dec_bn_{i}", f"dec_bni_{i}"


def dccrn_flax_params(state_dict: dict) -> dict:
    """DCCRN's ``state_dict`` → the JAX package's flax params; the BatchNorms'
    running statistics become ``mean``/``var`` where the port's model keeps
    them (``torch_compat``)."""
    enc = _ids(state_dict, r"^encoder\.(\d+)\.0\.")
    out = _spec_to_flax(state_dict, _dccrn_spec(
        enc, _ids(state_dict, r"^enhance\.(\d+)\."),
        _ids(state_dict, r"^enhance\.(\d+)\.r_trans\.")))
    for key, first, second in _dccrn_bns(len(enc)):
        node = _BN[0](state_dict, key)
        half = node["scale"].shape[0] // 2
        out["params"][first] = {k: v[:half] for k, v in node.items()}
        out["params"][second] = {k: v[half:] for k, v in node.items()}
    return out


def dccrn_state_dict(params: dict) -> dict:
    """The JAX package's DCCRN params, with or without the frozen statistics,
    → the port's ``state_dict``."""
    keys = _flat(params)
    enc = _ids(keys, r"^enc_(\d+)/")
    sd = _spec_to_torch(params, _dccrn_spec(enc, _ids(keys, r"^clstm_(\d+)/"),
                                            _ids(keys, r"^clstm_(\d+)/r_trans/")))
    p = params.get("params", params)
    for key, first, second in _dccrn_bns(len(enc)):
        halves = (_BN[1](p[first], key), _BN[1](p[second], key))
        sd.update({k: torch.from_numpy(np.concatenate([halves[0][k], halves[1][k]])
                                       .astype(np.float32)) for k in halves[0]})
    return sd


def _fsmn(f: str, t: str) -> list:
    """UniDeepFsmn (torch_import.py:913-922)."""
    return [(f"{f}/linear", f"{t}.linear", _LINEAR), (f"{f}/project", f"{t}.project", _LINEAR),
            (f"{f}/conv1", f"{t}.conv1", _FSMN_MEMORY)]


def _frcrn_spec() -> list:
    """FRCRN's two UNets (torch_import.py:943-985)."""
    spec = []
    for u in ("unet", "unet2"):
        spec += [(f"{u}/linear_re", f"{u}.linear.conv_re", _CONV2D),
                 (f"{u}/linear_im", f"{u}.linear.conv_im", _CONV2D)]
        for layer in ("L1", "L2"):
            spec += (_fsmn(f"{u}/fsmn/re_{layer}", f"{u}.fsmn.fsmn_re_{layer}")
                     + _fsmn(f"{u}/fsmn/im_{layer}", f"{u}.fsmn.fsmn_im_{layer}"))
        for i in range(7):
            for part in ("re", "im"):
                spec += [(f"{u}/encoder_{i}/conv_{part}", f"{u}.encoder{i}.conv.conv_{part}",
                          _CONV2D),
                         (f"{u}/encoder_{i}/bn_{part}", f"{u}.encoder{i}.bn.bn_{part}", _BN),
                         (f"{u}/decoder_{i}/conv_{part}",
                          f"{u}.decoder{i}.transconv.tconv_{part}", _CONVT2D),
                         (f"{u}/decoder_{i}/bn_{part}", f"{u}.decoder{i}.bn.bn_{part}", _BN)]
            stages = [("se_enc", "se_layer_enc")] + ([("se_dec", "se_layer_dec")] if i < 5 else [])
            for f, t in stages:
                for part in ("r", "i"):
                    spec += [(f"{u}/{f}_{i}/fc_{part}_1", f"{u}.{t}{i}.fc_{part}.0", _LINEAR),
                             (f"{u}/{f}_{i}/fc_{part}_2", f"{u}.{t}{i}.fc_{part}.2", _LINEAR)]
            fsmns = ([("fsmn_enc", "fsmn_enc")] if i > 0 else []) + (
                [("fsmn_dec", "fsmn_dec")] if i < 6 else [])
            for f, t in fsmns:
                spec += (_fsmn(f"{u}/{f}_{i}/re_L1", f"{u}.{t}{i}.fsmn_re_L1")
                         + _fsmn(f"{u}/{f}_{i}/im_L1", f"{u}.{t}{i}.fsmn_im_L1"))
    return spec


def frcrn_flax_params(state_dict: dict) -> dict:
    """FRCRN's ``state_dict`` → the JAX package's flax params (with the
    frozen statistics where the port's model keeps them)."""
    return _spec_to_flax(state_dict, _frcrn_spec())


def frcrn_state_dict(params: dict) -> dict:
    """The JAX package's FRCRN params → the port's ``state_dict``."""
    return _spec_to_torch(params, _frcrn_spec())


def _bsrnn_espnet_spec(bands, layers) -> list:
    """BSRNNESPNet (torch_import.py:1035-1068)."""
    bs = "separator.bsrnn"
    spec = []
    for i in bands:
        spec += [(f"band_split/norm_{i}", f"{bs}.band_split.norm.{i}", _GN),
                 (f"band_split/fc_{i}", f"{bs}.band_split.fc.{i}", _CONV1D)]
        for tag, tkey in (("mask", "mlp_mask"), ("residual", "mlp_residual")):
            f, t = f"mask_decoder/{tag}_{i}", f"{bs}.mask_decoder.{tkey}.{i}"
            spec += [(f"{f}_norm", f"{t}.0", _GN), (f"{f}_c1", f"{t}.1", _CONV1D),
                     (f"{f}_c2", f"{t}.3", _CONV1D)]
    for i in layers:
        for part in ("time", "freq"):
            spec += [(f"norm_{part}_{i}", f"{bs}.norm_{part}.{i}", _GN),
                     (f"rnn_{part}_{i}", f"{bs}.rnn_{part}.{i}", _LSTM),
                     (f"fc_{part}_{i}", f"{bs}.fc_{part}.{i}", _LINEAR)]
    return spec


def bsrnn_espnet_flax_params(state_dict: dict) -> dict:
    """BSRNNESPNet's ``state_dict`` → the JAX package's flax params."""
    return _spec_to_flax(state_dict, _bsrnn_espnet_spec(
        _ids(state_dict, r"\.band_split\.fc\.(\d+)\."), _ids(state_dict, r"\.rnn_time\.(\d+)\.")))


def bsrnn_espnet_state_dict(params: dict) -> dict:
    """The JAX package's BSRNNESPNet params → the port's ``state_dict``."""
    keys = _flat(params)
    return _spec_to_torch(params, _bsrnn_espnet_spec(_ids(keys, r"^band_split/fc_(\d+)/"),
                                                     _ids(keys, r"^rnn_time_(\d+)/")))


# --- the GaGNet family (torch_import.py:503-608, 790-870) ------------------
# The affine instance norm under ``norm`` ↔ scale, bias; G2Net's pair of
# gated convs (``conv.1``, ``gate_conv.1``) ↔ one conv of both halves, the
# gate's second.
_IN = (lambda sd, k: {"scale": _np(sd[f"{k}.norm.weight"]), "bias": _np(sd[f"{k}.norm.bias"])},
       lambda n, k: {f"{k}.norm.weight": np.asarray(n["scale"]),
                     f"{k}.norm.bias": np.asarray(n["bias"])})


def _gate_pair_to_flax(sd: dict, key: str) -> dict:
    a, g = _CONV2D[0](sd, f"{key}.conv.1"), _CONV2D[0](sd, f"{key}.gate_conv.1")
    return {"conv": {"kernel": _arr(np.concatenate([a["kernel"], g["kernel"]], axis=-1)),
                     "bias": np.concatenate([a["bias"], g["bias"]])}}


def _gate_pair_to_torch(node: dict, key: str) -> dict:
    kernel, bias = np.asarray(node["conv"]["kernel"]), np.asarray(node["conv"]["bias"])
    half = kernel.shape[-1] // 2
    return {**_CONV2D[1]({"kernel": kernel[..., :half], "bias": bias[:half]}, f"{key}.conv.1"),
            **_CONV2D[1]({"kernel": kernel[..., half:], "bias": bias[half:]},
                         f"{key}.gate_conv.1")}


_GATE_PAIR = (_gate_pair_to_flax, _gate_pair_to_torch)


# A gated in-conv (flax node, torch key, kernel) → spec entries: GaGNet's
# and TaylorSENet's one conv (after a causal pad when the time kernel is
# over 1), G2Net's pair, TaylorSENet's transposed one (before a chomp).
def _gate(f: str, t: str, k) -> list:
    return [(f"{f}/conv", f"{t}.conv.1" if k[0] > 1 else f"{t}.conv", _CONV2D)]


def _gate_pair(f: str, t: str, k) -> list:
    return [(f, t, _GATE_PAIR)]


def _gate_t(f: str, t: str, k) -> list:
    return [(f"{f}/conv", f"{t}.conv.0" if k[0] > 1 else f"{t}.conv", _CONVT2D)]


def _unet_spec(f: str, t: str, k1, k2, scale: int, gate, norm) -> list:
    """One EnUnetModule: the in-conv, then ``scale`` conv and deconv units,
    whose pad or chomp (time kernel over 1) shifts their later slots;
    ``norm`` is ``_IN`` or None (TaylorSENet's carry no parameters)."""
    spec = gate(f"{f}/in_conv_gate", f"{t}.in_conv.0", k1) + [
        (f"{f}/in_conv_prelu", f"{t}.in_conv.2", _PRELU)]
    if norm:
        spec.append((f"{f}/in_conv_norm", f"{t}.in_conv.1", norm))
    c, n = (1, 2) if k2[0] > 1 else (0, 1)
    for j in range(scale):
        e, d = f"{t}.enco.{j}.conv", f"{t}.deco.{j}.deconv"
        spec += [(f"{f}/enco_{j}/conv", f"{e}.{c}", _CONV2D),
                 (f"{f}/enco_{j}/prelu", f"{e}.{c + 2}", _PRELU),
                 (f"{f}/deco_{j}/deconv", f"{d}.0", _CONVT2D),
                 (f"{f}/deco_{j}/prelu", f"{d}.{n + 1}", _PRELU)]
        if norm:
            spec += [(f"{f}/enco_{j}/norm", f"{e}.{c + 1}", norm),
                     (f"{f}/deco_{j}/norm", f"{d}.{n}", norm)]
    return spec


def _u2_encoder_spec(f: str, t: str, k1, k2, first, gate, norm) -> list:
    """U2Encoder (torch_import.py:547-576): four UNet modules and the last
    gated conv."""
    spec = []
    for i, (k, scale) in enumerate([(first, 4), (k1, 3), (k1, 2), (k1, 1)]):
        spec += _unet_spec(f"{f}/unet_{i}", f"{t}.meta_unet_list.{i}", k, k2, scale, gate, norm)
    spec += gate(f"{f}/last_gate", f"{t}.last_conv.0", k1) + [
        (f"{f}/last_prelu", f"{t}.last_conv.2", _PRELU)]
    return spec + ([(f"{f}/last_norm", f"{t}.last_conv.1", norm)] if norm else [])


def _squeezed_tcm(f: str, t: str) -> list:
    """GaGNet's SqueezedTCM (torch_import.py:520-529)."""
    return [(f"{f}/in_conv", f"{t}.in_conv", _CONV1D),
            (f"{f}/d_prelu", f"{t}.d_conv.0", _PRELU), (f"{f}/d_norm", f"{t}.d_conv.1", _IN),
            (f"{f}/d_conv", f"{t}.d_conv.3", _CONV1D),
            (f"{f}/out_prelu", f"{t}.out_conv.0", _PRELU),
            (f"{f}/out_norm", f"{t}.out_conv.1", _IN), (f"{f}/out_conv", f"{t}.out_conv.2", _CONV1D)]


def _gated_tcm(f: str, t: str, branches, norm) -> list:
    """G2Net's GatedSqueezedTCM (torch_import.py:580-593) or, with
    ``left_conv``/``right_conv`` and no norm parameters, TaylorSENet's
    (:816-829)."""
    spec = [(f"{f}/in_conv", f"{t}.in_conv", _CONV1D),
            (f"{f}/out_prelu", f"{t}.out_conv.0", _PRELU),
            (f"{f}/out_conv", f"{t}.out_conv.2", _CONV1D)]
    spec += [(f"{f}/out_norm", f"{t}.out_conv.1", norm)] if norm else []
    for part, branch in zip(("main", "gate"), branches):
        spec += [(f"{f}/{part}_prelu", f"{t}.{branch}.0", _PRELU),
                 (f"{f}/{part}_conv", f"{t}.{branch}.3", _CONV1D)]
        spec += [(f"{f}/{part}_norm", f"{t}.{branch}.1", norm)] if norm else []
    return spec


def _count(keys, pattern: str) -> int:
    return len(_ids(keys, pattern))


def _gagnet_spec(q: int, p: int, n_dil: int, k1, k2) -> list:
    """GaGNet (torch_import.py:578-604)."""
    spec = _u2_encoder_spec("en", "en", k1, k2, (2, 5), _gate, _IN)
    for i in range(q):
        f, g, z = f"gag_{i}", f"gags.{i}.glance_block", f"gags.{i}.gaze_block"
        spec += [(f"{f}/glance_main", f"{g}.in_conv_main", _CONV1D),
                 (f"{f}/glance_gate", f"{g}.in_conv_gate.0", _CONV1D),
                 (f"{f}/glance_linear", f"{g}.linear_g.0", _CONV1D),
                 (f"{f}/gaze_main", f"{z}.in_conv_main", _CONV1D),
                 (f"{f}/gaze_gate", f"{z}.in_conv_gate.0", _CONV1D),
                 (f"{f}/gaze_linear_r", f"{z}.linear_r", _CONV1D),
                 (f"{f}/gaze_linear_i", f"{z}.linear_i", _CONV1D)]
        for pp in range(p):
            for fk, tk in ((f"glance_tcn_{pp}", f"{g}.tcn_g.{pp}"),
                           (f"gaze_tcn_r_{pp}", f"{z}.tcm_r.{pp}"),
                           (f"gaze_tcn_i_{pp}", f"{z}.tcm_i.{pp}")):
                for j in range(n_dil):
                    spec += _squeezed_tcm(f"{f}/{fk}/tcm_{j}", f"{tk}.tcns.{j}")
    return spec


def gagnet_flax_params(state_dict: dict, k1=(2, 3), k2=(1, 3)) -> dict:
    """GaGNet's ``state_dict`` → the JAX package's flax params
    (torch_import.py:578)."""
    sd = state_dict
    return _spec_to_flax(sd, _gagnet_spec(
        _count(sd, r"^gags\.(\d+)\."), _count(sd, r"^gags\.0\.glance_block\.tcn_g\.(\d+)\."),
        _count(sd, r"^gags\.0\.glance_block\.tcn_g\.0\.tcns\.(\d+)\."), tuple(k1), tuple(k2)))


def gagnet_state_dict(params: dict, k1=(2, 3), k2=(1, 3)) -> dict:
    """The JAX package's GaGNet params → the port's ``state_dict``."""
    keys = _flat(params)
    return _spec_to_torch(params, _gagnet_spec(
        _count(keys, r"^gag_(\d+)/"), _count(keys, r"^gag_0/glance_tcn_(\d+)/"),
        _count(keys, r"^gag_0/glance_tcn_0/tcm_(\d+)/"), tuple(k1), tuple(k2)))


_G2NET_HEADS = ("ri_en", "mag_en")


def _g2net_spec(heads, stages: int, tcn_num: int, n_dil: int, k1, k2) -> list:
    """G2Net (torch_import.py:596-628)."""
    spec = []
    for h in heads:
        spec += _u2_encoder_spec(h, h, k1, k2, (2, 5), _gate_pair, _IN)
    for i in range(stages):
        f, g, z = f"ggm_{i}", f"ggms.{i}.glance_branch", f"ggms.{i}.gaze_branch"
        spec += [(f"{f}/glance_in", f"{g}.in_conv", _CONV1D),
                 (f"{f}/glance_linear", f"{g}.linear_mag", _CONV1D),
                 (f"{f}/gaze_in_r", f"{z}.in_conv_r", _CONV1D),
                 (f"{f}/gaze_in_i", f"{z}.in_conv_i", _CONV1D),
                 (f"{f}/gaze_linear_r", f"{z}.linear_r", _LINEAR),
                 (f"{f}/gaze_linear_i", f"{z}.linear_i", _LINEAR)]
        for pp in range(tcn_num):
            for fk, tk in ((f"glance_tcn_{pp}", f"{g}.tcn_list.{pp}"),
                           (f"gaze_tcn_r_{pp}", f"{z}.tcn_r.{pp}"),
                           (f"gaze_tcn_i_{pp}", f"{z}.tcn_i.{pp}")):
                for j in range(n_dil):
                    spec += _gated_tcm(f"{f}/{fk}/tcm_{j}", f"{tk}.tcm_list.{j}",
                                       ("dd_conv_main", "dd_conv_gate"), _IN)
    return spec


def g2net_flax_params(state_dict: dict, k1=(2, 3), k2=(1, 3)) -> dict:
    """G2Net's ``state_dict`` → the JAX package's flax params
    (torch_import.py:628)."""
    sd = state_dict
    heads = [h for h in _G2NET_HEADS if any(k.startswith(f"{h}.") for k in sd)]
    return _spec_to_flax(sd, _g2net_spec(
        heads, _count(sd, r"^ggms\.(\d+)\."),
        _count(sd, r"^ggms\.0\.glance_branch\.tcn_list\.(\d+)\."),
        _count(sd, r"^ggms\.0\.glance_branch\.tcn_list\.0\.tcm_list\.(\d+)\."),
        tuple(k1), tuple(k2)))


def g2net_state_dict(params: dict, k1=(2, 3), k2=(1, 3)) -> dict:
    """The JAX package's G2Net params → the port's ``state_dict``."""
    keys = _flat(params)
    heads = [h for h in _G2NET_HEADS if any(k.startswith(f"{h}/") for k in keys)]
    return _spec_to_torch(params, _g2net_spec(
        heads, _count(keys, r"^ggm_(\d+)/"), _count(keys, r"^ggm_0/glance_tcn_(\d+)/"),
        _count(keys, r"^ggm_0/glance_tcn_0/tcm_(\d+)/"), tuple(k1), tuple(k2)))


def _taylorsenet_spec(order_num: int, p: int, n_dil: int, k1, k2) -> list:
    """TaylorSENet (torch_import.py:872-907): no norm parameters anywhere."""
    spec = (_u2_encoder_spec("zero_en", "zeroorderblock.en", k1, k2, (1, 5), _gate, None)
            + _u2_encoder_spec("separate_en", "separate_en", k1, k2, (1, 5), _gate, None))
    de = "zeroorderblock.de"
    for i, scale in enumerate((1, 2, 3, 4)):
        spec += _unet_spec(f"zero_de/unet_{i}", f"{de}.meta_unet_list.{i}", k1, k2, scale,
                           _gate_t, None)
    spec += _gate_t("zero_de/last_gate", f"{de}.last_conv.0", (1, 5)) + [
        ("zero_de/last_prelu", f"{de}.last_conv.2", _PRELU),
        ("zero_de/last_conv", f"{de}.last_conv.3", _CONV2D)]

    def tcms(f: str, t: str) -> list:
        return [e for i in range(p) for j in range(n_dil)
                for e in _gated_tcm(f"{f}_{i}/tcm_{j}", f"{t}.{i}.tcm_list.{j}",
                                    ("left_conv", "right_conv"), None)]

    spec += tcms("zero_tcm", "zeroorderblock.tcms")
    for k in range(order_num):
        hb = f"highorderblock_list.{k}"
        spec += [(f"ho_{k}_in", f"{hb}.in_conv", _CONV1D),
                 (f"ho_{k}_r", f"{hb}.real_resi", _CONV1D),
                 (f"ho_{k}_i", f"{hb}.imag_resi", _CONV1D)] + tcms(f"ho_{k}_tcm", f"{hb}.tcms")
    return spec


def taylorsenet_flax_params(state_dict: dict, k1=(1, 3), k2=(2, 3)) -> dict:
    """TaylorSENet's ``state_dict`` → the JAX package's flax params
    (torch_import.py:872)."""
    sd = state_dict
    return _spec_to_flax(sd, _taylorsenet_spec(
        _count(sd, r"^highorderblock_list\.(\d+)\."), _count(sd, r"^zeroorderblock\.tcms\.(\d+)\."),
        _count(sd, r"^zeroorderblock\.tcms\.0\.tcm_list\.(\d+)\."), tuple(k1), tuple(k2)))


def taylorsenet_state_dict(params: dict, k1=(1, 3), k2=(2, 3)) -> dict:
    """The JAX package's TaylorSENet params → the port's ``state_dict``."""
    keys = _flat(params)
    return _spec_to_torch(params, _taylorsenet_spec(
        _count(keys, r"^ho_(\d+)_in/"), _count(keys, r"^zero_tcm_(\d+)/"),
        _count(keys, r"^zero_tcm_0/tcm_(\d+)/"), tuple(k1), tuple(k2)))


# --- the sidecar models (Whisper, ECAPA-TDNN, PyanNet) ----------------------
# Each port module keeps its checkpoint's own names (HF Whisper, speechbrain,
# pyannote), so a published file loads into it as it is; these carry the JAX
# package's flax params (the trees its ``convert_*`` build from those files)
# into that naming, for holding both packages on the same weights.

# A leaf ``kernel`` (in, out) of a Dense ↔ a 1×1 sb-Conv1d weight (out, in, 1).
_DENSE_AS_CONV = (
    lambda sd, k: _with_bias({"kernel": _arr(_np(sd[f"{k}.weight"])[:, :, 0].T)}, sd, k),
    lambda n, k: _bias_back(n, k, {f"{k}.weight": np.asarray(n["kernel"]).T[:, :, None]}))
# An eval-mode BatchNorm: scale, bias, mean, var ↔ weight, bias, running stats.
_BN_STATS = (
    lambda sd, k: {"scale": _np(sd[f"{k}.weight"]), "bias": _np(sd[f"{k}.bias"]),
                   "mean": _np(sd[f"{k}.running_mean"]), "var": _np(sd[f"{k}.running_var"])},
    lambda n, k: {f"{k}.weight": np.asarray(n["scale"]), f"{k}.bias": np.asarray(n["bias"]),
                  f"{k}.running_mean": np.asarray(n["mean"]),
                  f"{k}.running_var": np.asarray(n["var"])})
# A flax Embed ↔ an nn.Embedding.
_EMBED = (lambda sd, k: {"embedding": _np(sd[f"{k}.weight"])},
          lambda n, k: {f"{k}.weight": np.asarray(n["embedding"])})


def _whisper_spec(enc_layers, dec_layers) -> list:
    """models/whisper.py's ``convert_whisper`` read backwards."""
    spec = [("conv1", "encoder.conv1", _CONV1D), ("conv2", "encoder.conv2", _CONV1D),
            ("enc_positions", "encoder.embed_positions.weight", _RAW),
            ("enc_ln", "encoder.layer_norm", _LN),
            ("embed_tokens", "decoder.embed_tokens", _EMBED),
            ("dec_positions", "decoder.embed_positions.weight", _RAW),
            ("dec_ln", "decoder.layer_norm", _LN)]
    for side, layers in (("enc", enc_layers), ("dec", dec_layers)):
        for i in layers:
            f, t = f"{side}_blocks_{i}", f"{'encoder' if side == 'enc' else 'decoder'}.layers.{i}"
            attns = ["self_attn"] + (["encoder_attn"] if side == "dec" else [])
            spec += [(f"{f}/{a}_layer_norm", f"{t}.{a}_layer_norm", _LN) for a in attns]
            spec += [(f"{f}/{a}/{p}", f"{t}.{a}.{p}", _LINEAR) for a in attns
                     for p in ("q_proj", "k_proj", "v_proj", "out_proj")]
            spec += [(f"{f}/final_layer_norm", f"{t}.final_layer_norm", _LN),
                     (f"{f}/fc1", f"{t}.fc1", _LINEAR), (f"{f}/fc2", f"{t}.fc2", _LINEAR)]
    return spec


def whisper_from_flax(params: dict) -> dict:
    """The JAX package's Whisper params (``convert_whisper``'s tree) → the
    port's ``state_dict`` (HF names)."""
    keys = _flat(params)
    return _spec_to_torch(params, _whisper_spec(_ids(keys, r"^enc_blocks_(\d+)/"),
                                                _ids(keys, r"^dec_blocks_(\d+)/")))


def _tdnn(f: str, t: str) -> list:
    return [(f"{f}/conv", f"{t}.conv.conv", _CONV1D), (f"{f}/norm", f"{t}.norm.norm", _BN_STATS)]


def _ecapa_spec(inner) -> list:
    """models/ecapa.py's ``convert_ecapa`` read backwards (speechbrain's
    names)."""
    spec = (_tdnn("block0", "blocks.0") + _tdnn("mfa", "mfa") + _tdnn("asp/tdnn", "asp.tdnn")
            + [("asp/conv", "asp.conv.conv", _CONV1D), ("asp_bn", "asp_bn.norm", _BN_STATS),
               ("fc", "fc.conv", _DENSE_AS_CONV)])
    for i in range(1, 4):
        f, t = f"block{i}", f"blocks.{i}"
        spec += (_tdnn(f"{f}/tdnn1", f"{t}.tdnn1") + _tdnn(f"{f}/tdnn2", f"{t}.tdnn2")
                 + [(f"{f}/se/conv{j}", f"{t}.se_block.conv{j}.conv", _CONV1D) for j in (1, 2)])
        for j in inner:
            spec += _tdnn(f"{f}/res2net/block{j}", f"{t}.res2net_block.blocks.{j}")
    return spec


def ecapa_from_flax(params: dict) -> dict:
    """The JAX package's EcapaTdnn params → the port's ``state_dict``
    (speechbrain's names)."""
    return _spec_to_torch(params, _ecapa_spec(_ids(_flat(params),
                                                   r"^block1/res2net/block(\d+)/")))


def _pyannet_lstm(i: int):
    """Layer ``i`` of the stacked BiLSTM ↔ ``lstm{i}``'s two cells."""
    return (lambda sd, k: {"OptimizedLSTMCell_0": _cell_to_flax(sd, k, f"l{i}"),
                           "OptimizedLSTMCell_1": _cell_to_flax(sd, k, f"l{i}_reverse")},
            lambda n, k: {**_cell_to_torch(n["OptimizedLSTMCell_0"], k, f"l{i}"),
                          **_cell_to_torch(n["OptimizedLSTMCell_1"], k, f"l{i}_reverse")})


def _pyannet_spec(lstms, linears) -> list:
    """models/pyannet.py's ``convert_pyannet`` read backwards (pyannote's
    names)."""
    s, t = "sincnet", "sincnet"
    spec = [(f"{s}/sinc/low_hz", f"{t}.conv1d.0.filterbank.low_hz_", _RAW),
            (f"{s}/sinc/band_hz", f"{t}.conv1d.0.filterbank.band_hz_", _RAW),
            (f"{s}/wav_norm", f"{t}.wav_norm1d", _LN),
            (f"{s}/conv1", f"{t}.conv1d.1", _CONV1D), (f"{s}/conv2", f"{t}.conv1d.2", _CONV1D),
            ("classifier", "classifier", _LINEAR)]
    spec += [(f"{s}/norm{i}", f"{t}.norm1d.{i}", _LN) for i in range(3)]
    spec += [(f"lstm{i}", "lstm", _pyannet_lstm(i)) for i in lstms]
    spec += [(f"linear{j}", f"linear.{j}", _LINEAR) for j in linears]
    return spec


def pyannet_from_flax(params: dict) -> dict:
    """The JAX package's PyanNet params → the port's ``state_dict``
    (pyannote's names)."""
    keys = _flat(params)
    return _spec_to_torch(params, _pyannet_spec(_ids(keys, r"^lstm(\d+)/"),
                                                _ids(keys, r"^linear(\d+)/")))
