"""A minimal ONNX executor in PyTorch (no onnx / onnxruntime dependency).

Port of ``sonicsim_tpu.metrics.onnx_jax``. The reference scores
DNSMOS/SigMOS through onnxruntime sessions (separation/look2hear/metrics/
dnsmos.py:22-95); this module parses the protobuf wire format directly (the
subset of ModelProto/GraphProto/NodeProto/TensorProto/AttributeProto the MOS
models use, copied from the JAX package) and runs the graph with torch ops
on one device. An op it lacks raises, naming the op.

Where values live. Float initializers and the graph's inputs go to the
model's device (float32, as ``jnp.asarray`` makes them with x64 off).
Integer initializers and ``Shape`` outputs stay on the host: they are the
shapes, axes and indices that ``Reshape``, ``Slice``, ``Squeeze``,
``Unsqueeze`` and ``Reduce*`` read as Python numbers, and ops on host values
alone (shape arithmetic) run on the host. An op that mixes the two brings
its host operands to the device. A shape or axes input computed on the
device raises: nothing copies a device tensor to the host to run an op.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..bridge import resolve_device

# --- protobuf wire-format reader (a copy of onnx_jax's) ----------------------


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _fields(buf) -> dict[int, list]:
    out: dict[int, list] = {}
    for field, _wire, val in _iter_fields(memoryview(bytes(buf))):
        out.setdefault(field, []).append(val)
    return out


_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
           9: np.bool_, 10: np.float16, 11: np.float64}


def _parse_tensor(buf) -> tuple[str, np.ndarray]:
    f = _fields(buf)
    dims = [int(v) for v in f.get(1, [])]
    dtype = _DTYPES[int(f.get(2, [1])[0])]
    name = bytes(f.get(8, [b""])[0]).decode()
    if 9 in f:  # raw_data
        arr = np.frombuffer(bytes(f[9][0]), dtype=dtype)
    elif 4 in f:  # float_data (packed)
        arr = np.frombuffer(bytes(f[4][0]), dtype="<f4")
    elif 7 in f:  # int64_data (packed varints)
        vals = []
        mv = memoryview(bytes(f[7][0]))
        pos = 0
        while pos < len(mv):
            v, pos = _read_varint(mv, pos)
            if v >= 1 << 63:
                v -= 1 << 64
            vals.append(v)
        arr = np.array(vals, np.int64)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr


def _parse_attr(buf) -> tuple[str, object]:
    f = _fields(buf)
    name = bytes(f[1][0]).decode()
    atype = int(f.get(20, [0])[0])
    if atype == 1:  # FLOAT
        return name, struct.unpack("<f", bytes(f[2][0]))[0]
    if atype == 2:  # INT
        v = int(f[3][0])
        return name, v - (1 << 64) if v >= 1 << 63 else v
    if atype == 3:  # STRING
        return name, bytes(f[4][0]).decode()
    if atype == 4:  # TENSOR
        return name, _parse_tensor(f[5][0])[1]
    if atype == 6:  # FLOATS
        raw = bytes(f[7][0]) if 7 in f else b""
        return name, np.frombuffer(raw, "<f4").tolist()
    if atype == 7:  # INTS
        vals = []
        if 8 in f:
            for item in f[8]:
                if isinstance(item, int):
                    vals.append(item)
                else:  # packed
                    mv = memoryview(bytes(item))
                    pos = 0
                    while pos < len(mv):
                        v, pos = _read_varint(mv, pos)
                        vals.append(v - (1 << 64) if v >= 1 << 63 else v)
        return name, vals
    return name, None


def parse_onnx(path: str | Path) -> dict:
    """→ {"nodes": [...], "initializers": {name: array},
         "inputs": [names], "outputs": [names]}"""
    data = Path(path).read_bytes()
    model = _fields(data)
    graph = _fields(model[7][0])  # ModelProto.graph
    nodes = []
    for nb in graph.get(1, []):
        nf = _fields(nb)
        nodes.append(
            {
                "inputs": [bytes(v).decode() for v in nf.get(1, [])],
                "outputs": [bytes(v).decode() for v in nf.get(2, [])],
                "op": bytes(nf.get(4, [b""])[0]).decode(),
                "attrs": dict(_parse_attr(a) for a in nf.get(5, [])),
            }
        )
    inits = dict(_parse_tensor(t) for t in graph.get(5, []))

    def _vi_name(buf):
        return bytes(_fields(buf)[1][0]).decode()

    inputs = [
        n for n in (_vi_name(v) for v in graph.get(11, [])) if n not in inits
    ]
    outputs = [_vi_name(v) for v in graph.get(12, [])]
    return {"nodes": nodes, "initializers": inits, "inputs": inputs,
            "outputs": outputs}


# --- op interpreter -----------------------------------------------------------

# ONNX Cast targets; double is float32, as ``astype(float64)`` gives in the
# JAX executor with x64 off.
_CAST = {1: torch.float32, 2: torch.uint8, 3: torch.int8, 6: torch.int32, 7: torch.int64,
         9: torch.bool, 10: torch.float16, 11: torch.float32}
_HOST = torch.device("cpu")


def _host_values(t: torch.Tensor, what: str) -> list:
    """A shape, axes or index input as Python numbers, from the host."""
    if t.device.type != "cpu":
        raise NotImplementedError(
            f"ONNX {what} computed on {t.device}: the executor reads shapes and axes from "
            "host values (initializers, Shape) and does not copy a device tensor back")
    return t.reshape(-1).tolist()


def _together(*xs):
    """The operands on one device: host values join a device operand."""
    dev = next((x.device for x in xs if x is not None and x.device.type != "cpu"), _HOST)
    return [x if x is None or x.device == dev else x.to(dev) for x in xs]


def _pool2d(x, kshape, strides, pads, reduce: str):
    """Sum or max over windows of (N, C, H, W) with ONNX pads [t, l, b, r]
    (0 for a sum, −inf for a max)."""
    t_, l_, b_, r_ = (list(pads) + [0, 0, 0, 0])[:4] if pads else (0, 0, 0, 0)
    x = F.pad(x, (l_, r_, t_, b_), value=float("-inf") if reduce == "max" else 0.0)
    if reduce == "max":
        return F.max_pool2d(x, tuple(kshape), tuple(strides))
    # avg_pool2d over the padded input holds no padding of its own: × k = sum
    return F.avg_pool2d(x, tuple(kshape), tuple(strides)) * float(np.prod(kshape))


def _conv(x, w, b, attrs):
    spatial = w.ndim - 2
    strides = tuple(attrs.get("strides", [1] * spatial))
    pads = attrs.get("pads")
    dil = tuple(attrs.get("dilations", [1] * spatial))
    group = int(attrs.get("group", 1))
    auto = attrs.get("auto_pad")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        # The surplus cell goes at the end for SAME_UPPER and at the
        # beginning for SAME_LOWER.
        padding = []
        for i in range(spatial):
            in_i = x.shape[2 + i]
            eff_k = (w.shape[2 + i] - 1) * dil[i] + 1
            total = max((-(-in_i // strides[i]) - 1) * strides[i] + eff_k - in_i, 0)
            small, big = total // 2, total - total // 2
            padding.append((small, big) if auto == "SAME_UPPER" else (big, small))
    elif pads:
        padding = [(pads[i], pads[i + spatial]) for i in range(spatial)]
    else:
        padding = [(0, 0)] * spatial
    flat = [p for pair in reversed(padding) for p in pair]  # F.pad: last axis first
    if any(flat):
        x = F.pad(x, flat)
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[spatial]
    return conv(x, w, b, strides, 0, dil, group)


def _gemm(a, b, c, attrs):
    if attrs.get("transA"):
        a = a.T
    if attrs.get("transB"):
        b = b.T
    out = attrs.get("alpha", 1.0) * (a @ b)
    if c is not None:
        out = out + attrs.get("beta", 1.0) * c
    return out


def _axes(at, ins, index: int):
    """An op's axes: its attribute, else its input ``index`` (opset 13+/18)."""
    axes = at.get("axes")
    if axes is None and len(ins) > index and ins[index] is not None:
        axes = _host_values(ins[index], "axes")
    return axes


def _slice(x, starts, ends, axes, steps):
    for s_, e_, a_, st_ in zip(starts, ends, axes, steps):
        # tf2onnx encodes "to the end" as -1 (the ONNX spec reads it as
        # last-exclusive); INT_MAX likewise.
        end = None if (e_ == -1 or e_ >= 2**31 - 1) else e_
        idx = range(*slice(s_, end, st_).indices(x.shape[a_]))
        if st_ == 1:
            x = x.narrow(a_, idx.start, len(idx))
        else:
            x = x.index_select(a_, torch.arange(idx.start, idx.stop, idx.step, device=x.device))
    return x


def _run(op: str, ins: list, at: dict):
    """One node's output."""
    if op == "Conv":
        x, w, b = _together(ins[0], ins[1], ins[2] if len(ins) > 2 else None)
        return _conv(x, w, b, at)
    if op == "Gemm":
        return _gemm(*_together(ins[0], ins[1], ins[2] if len(ins) > 2 else None), at)
    if op == "MatMul":
        a, b = _together(ins[0], ins[1])
        return a @ b
    unary = {"Relu": torch.relu, "Sigmoid": torch.sigmoid, "Tanh": torch.tanh,
             "Sqrt": torch.sqrt, "Exp": torch.exp, "Log": torch.log, "Identity": lambda v: v}
    if op in unary:
        return unary[op](ins[0])
    binary = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul, "Div": torch.div,
              "Pow": torch.pow}
    if op in binary:
        return binary[op](*_together(ins[0], ins[1]))
    if op in ("Max", "Min"):
        fn = torch.maximum if op == "Max" else torch.minimum
        xs = _together(*ins)
        out = xs[0]
        for other in xs[1:]:
            out = fn(out, other)
        return out
    if op == "Clip":
        # opset 11+: min and max are optional inputs 1 and 2
        lo = ins[1] if len(ins) > 1 and ins[1] is not None else at.get("min")
        hi = ins[2] if len(ins) > 2 and ins[2] is not None else at.get("max")
        x = ins[0]
        if isinstance(lo, torch.Tensor):
            x, lo = _together(x, lo)
        if isinstance(hi, torch.Tensor):
            x, hi = _together(x, hi)
        if lo is not None:
            x = torch.maximum(x, lo) if isinstance(lo, torch.Tensor) else x.clamp(min=lo)
        if hi is not None:
            x = torch.minimum(x, hi) if isinstance(hi, torch.Tensor) else x.clamp(max=hi)
        return x
    if op == "MaxPool":
        k = at["kernel_shape"]
        return _pool2d(ins[0], k, at.get("strides", [1] * len(k)), at.get("pads"), "max")
    if op == "AveragePool":
        k = at["kernel_shape"]
        strides = at.get("strides", [1] * len(k))
        pads = at.get("pads")
        summed = _pool2d(ins[0], k, strides, pads, "sum")
        if pads and any(pads) and not at.get("count_include_pad", 0):
            # ONNX's default leaves the padded cells out of the mean
            count = _pool2d(torch.ones_like(ins[0]), k, strides, pads, "sum")
            return summed / count
        return summed / float(np.prod(k))
    if op == "GlobalAveragePool":
        return ins[0].mean(dim=tuple(range(2, ins[0].ndim)), keepdim=True)
    if op == "Flatten":
        ax = at.get("axis", 1)
        return ins[0].reshape((int(np.prod(ins[0].shape[:ax])), -1))
    if op == "Reshape":
        shape = [int(s) for s in _host_values(ins[1], "Reshape shape")]
        return ins[0].reshape([ins[0].shape[i] if s == 0 else s for i, s in enumerate(shape)])
    if op == "Transpose":
        perm = at.get("perm")
        return ins[0].permute(*(perm if perm is not None else reversed(range(ins[0].ndim))))
    if op == "Concat":
        return torch.cat(_together(*ins), dim=at.get("axis", 0))
    if op == "Squeeze":
        axes = _axes(at, ins, 1)
        out = ins[0]
        if axes is None:  # axes omitted: every unit axis
            axes = [i for i, s in enumerate(out.shape) if s == 1]
        for ax in sorted(axes, reverse=True):
            out = out.squeeze(ax)
        return out
    if op == "Unsqueeze":
        axes = _axes(at, ins, 1)
        if axes is None:
            raise ValueError("Unsqueeze node without axes")
        out = ins[0]
        for ax in sorted(axes):
            out = out.unsqueeze(ax)
        return out
    if op == "Softmax":
        return torch.softmax(ins[0], dim=at.get("axis", -1))
    if op in ("ReduceMax", "ReduceSum", "ReduceMean"):
        # opset 18 moved axes to input 1; no axes reduces every axis
        axes = _axes(at, ins, 1)
        x = ins[0]
        dims = tuple(axes) if axes else tuple(range(x.ndim))
        keep = bool(at.get("keepdims", 1))
        fn = {"ReduceMax": torch.amax, "ReduceSum": torch.sum, "ReduceMean": torch.mean}[op]
        return fn(x, dim=dims, keepdim=keep)
    if op == "BatchNormalization":
        x, scale, bias, mean, var = _together(*ins[:5])
        eps = at.get("epsilon", 1e-5)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return ((x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
                * scale.reshape(shape) + bias.reshape(shape))
    if op == "Shape":
        return torch.tensor(tuple(ins[0].shape), dtype=torch.int64)  # a host value
    if op == "Gather":
        x, idx = _together(ins[0], ins[1])
        ax = at.get("axis", 0) % x.ndim
        idx = idx.long()
        idx = torch.where(idx < 0, idx + x.shape[ax], idx)
        out = x.index_select(ax, idx.reshape(-1))
        return out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])
    if op == "Cast":
        return ins[0].to(_CAST.get(int(at.get("to", 1)), torch.float32))
    if op == "Slice":
        starts = _host_values(ins[1], "Slice starts")
        ends = _host_values(ins[2], "Slice ends")
        axes = (_host_values(ins[3], "Slice axes") if len(ins) > 3 and ins[3] is not None
                else list(range(len(starts))))
        steps = (_host_values(ins[4], "Slice steps") if len(ins) > 4 and ins[4] is not None
                 else [1] * len(starts))
        return _slice(ins[0], starts, ends, axes, steps)
    raise NotImplementedError(f"ONNX op not supported: {op}")


class OnnxTorchModel:
    """A parsed ONNX graph run with torch ops on ``device`` (the card unless
    the caller names another)."""

    def __init__(self, path: str | Path, device=None):
        self._load(parse_onnx(path), device)

    @classmethod
    def from_graph(cls, graph: dict, device=None) -> "OnnxTorchModel":
        """From ``parse_onnx``'s dict, or one built by hand."""
        model = cls.__new__(cls)
        model._load(graph, device)
        return model

    def _load(self, g: dict, device) -> None:
        self.device = resolve_device(device)
        self.nodes = g["nodes"]
        self.inits = {k: self._value(v) for k, v in g["initializers"].items()}
        self.input_names = g["inputs"]
        self.output_names = g["outputs"]

    def _value(self, arr) -> torch.Tensor:
        """Floats to the device as float32; integers stay on the host."""
        arr = np.array(arr)  # a writable copy of the file's buffer
        if np.issubdtype(arr.dtype, np.floating):
            return torch.from_numpy(arr.astype(np.float32)).to(self.device)
        return torch.from_numpy(arr)

    def ops_used(self) -> set[str]:
        return {n["op"] for n in self.nodes}

    def __call__(self, *args) -> list[torch.Tensor]:
        env: dict[str, torch.Tensor] = dict(self.inits)
        for name, arr in zip(self.input_names, args):
            if isinstance(arr, torch.Tensor):
                env[name] = arr.to(self.device, torch.float32 if arr.is_floating_point()
                                   else arr.dtype)
            else:
                env[name] = self._value(arr)
                if env[name].device != self.device:  # integer model inputs: data
                    env[name] = env[name].to(self.device)
        for node in self.nodes:
            ins = [env[i] if i else None for i in node["inputs"]]
            out = _run(node["op"], ins, node["attrs"])
            for oname in node["outputs"]:
                env[oname] = out
        return [env[o] for o in self.output_names]
