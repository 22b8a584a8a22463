"""The port's ONNX executor (``sonicsim_tpu_torch.metrics.onnx_torch``)
against the JAX package's (``sonicsim_tpu.metrics.onnx_jax``), on the CPU:

* every op the JAX executor runs, on hand-built node graphs (as
  tests/test_onnx_ops.py builds them), with the corners that file covers
  (Clip with min only, default pool strides, ``count_include_pad``,
  axes-as-input Reduce*, axes-omitted Squeeze, SAME_LOWER) and a few more
  (grouped and dilated convs, Gemm's transposes, negative Gather indices,
  Slice's steps and its "-1 is the end" reading);
* the protobuf reader on hand-serialized bytes (``chip_smoke.onnx_bytes``
  and raw TensorProto/AttributeProto fields), on both sides;
* chip_smoke.py's seeded DNSMOS- and SigMOS-shaped graphs, as files.

Tolerance: outputs within 1e-5 · max|ref| (float32 convolutions, matmuls
and reductions summed in another order); integer and shape results equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sonicsim_tpu.metrics import onnx_jax as J
from sonicsim_tpu_torch.metrics import onnx_torch as T
from torch_threads import one_intra_op_thread  # noqa: F401

REL = 1e-5


def _node(op, inputs, outputs=("y",), **attrs):
    return {"op": op, "inputs": list(inputs), "outputs": list(outputs), "attrs": attrs}


def _pair(nodes, inputs, outputs=("y",), inits=None):
    """The same graph in both executors."""
    inits = inits or {}
    jm = J.OnnxJaxModel.__new__(J.OnnxJaxModel)
    jm.nodes, jm.input_names, jm.output_names = nodes, list(inputs), list(outputs)
    jm.inits = {k: jnp.asarray(v) for k, v in inits.items()}
    tm = T.OnnxTorchModel.from_graph({"nodes": nodes, "initializers": inits,
                                      "inputs": list(inputs), "outputs": list(outputs)}, "cpu")
    return jm, tm


def _same(jm, tm, *args):
    refs, outs = jm(*args), tm(*args)
    assert len(refs) == len(outs)
    for ref, out in zip(refs, outs):
        ref = np.asarray(ref)
        out = out.numpy()
        assert out.shape == ref.shape
        if np.issubdtype(ref.dtype, np.floating):
            np.testing.assert_allclose(out, ref, rtol=0, atol=REL * max(np.abs(ref).max(), 1e-30))
        else:
            np.testing.assert_array_equal(out, ref)
    return outs


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


W = dict(w1=_x(6, 2, 3, seed=1), b1=_x(6, seed=2), w2=_x(4, 3, 3, 2, seed=3), b2=_x(4, seed=4),
         wg=_x(4, 1, 3, seed=5))
OPS = {
    "conv1d-pads-strides": ([_node("Conv", ["x", "w1", "b1"], pads=[2, 1], strides=[2])],
                            {"w1": W["w1"], "b1": W["b1"]}, [_x(2, 2, 17)]),
    "conv1d-dilated": ([_node("Conv", ["x", "w1"], dilations=[3])], {"w1": W["w1"]},
                       [_x(2, 2, 17)]),
    "conv1d-grouped": ([_node("Conv", ["x", "wg"], group=4, pads=[1, 1])], {"wg": W["wg"]},
                       [_x(1, 4, 9)]),
    "conv2d-same-upper": ([_node("Conv", ["x", "w2", "b2"], strides=[2, 3], auto_pad="SAME_UPPER")],
                          {"w2": W["w2"], "b2": W["b2"]}, [_x(2, 3, 11, 10)]),
    "conv2d-same-lower": ([_node("Conv", ["x", "w2"], strides=[2, 2], auto_pad="SAME_LOWER")],
                          {"w2": W["w2"]}, [_x(1, 3, 9, 7)]),
    "conv2d-pads": ([_node("Conv", ["x", "w2", "b2"], pads=[1, 0, 2, 1])],
                    {"w2": W["w2"], "b2": W["b2"]}, [_x(1, 3, 6, 6)]),
    "gemm": ([_node("Gemm", ["a", "b", "c"], alpha=0.5, beta=2.0)], {"b": _x(5, 3), "c": _x(3)},
             [_x(4, 5)]),
    "gemm-transposed": ([_node("Gemm", ["a", "b"], transA=1, transB=1)], {"b": _x(3, 5)},
                        [_x(5, 4)]),
    "matmul": ([_node("MatMul", ["a", "b"])], {"b": _x(2, 5, 3)}, [_x(2, 4, 5)]),
    **{op.lower(): ([_node(op, ["x"])], {}, [_x(3, 7)]) for op in
       ("Relu", "Sigmoid", "Tanh", "Exp", "Identity")},
    "sqrt": ([_node("Sqrt", ["x"])], {}, [np.abs(_x(3, 7)) + 0.1]),
    "log": ([_node("Log", ["x"])], {}, [np.abs(_x(3, 7)) + 0.1]),
    **{op.lower(): ([_node(op, ["x", "c"])], {"c": _x(1, 7, seed=9)}, [_x(3, 7)]) for op in
       ("Add", "Sub", "Mul")},
    "div": ([_node("Div", ["x", "c"])], {"c": np.abs(_x(7, seed=9)) + 0.5}, [_x(3, 7)]),
    "pow": ([_node("Pow", ["x", "c"])], {"c": np.float32(2.0)}, [_x(3, 7)]),
    "clip-inputs": ([_node("Clip", ["x", "lo", "hi"])],
                    {"lo": np.float32(-0.5), "hi": np.float32(0.7)}, [_x(3, 7)]),
    "clip-min-only": ([_node("Clip", ["x", "lo"])], {"lo": np.float32(0.0)}, [_x(3, 7)]),
    "clip-max-skipped-min": ([_node("Clip", ["x", "", "hi"])], {"hi": np.float32(0.2)},
                             [_x(3, 7)]),
    "clip-attrs": ([_node("Clip", ["x"], min=-0.25, max=0.5)], {}, [_x(3, 7)]),
    "maxpool-default-stride": ([_node("MaxPool", ["x"], kernel_shape=[1, 3])], {},
                               [_x(1, 2, 3, 8)]),
    "maxpool-pads": ([_node("MaxPool", ["x"], kernel_shape=[3, 2], strides=[2, 2],
                            pads=[1, 0, 1, 1])], {}, [_x(2, 2, 7, 6)]),
    "averagepool-excludes-pad": ([_node("AveragePool", ["x"], kernel_shape=[3, 3],
                                        strides=[2, 1], pads=[1, 1, 1, 1])], {}, [_x(1, 2, 7, 5)]),
    "averagepool-count-include-pad": ([_node("AveragePool", ["x"], kernel_shape=[1, 3],
                                             pads=[0, 1, 0, 1], count_include_pad=1)], {},
                                      [_x(1, 2, 3, 5)]),
    "averagepool-no-pads": ([_node("AveragePool", ["x"], kernel_shape=[2, 2], strides=[2, 2])],
                            {}, [_x(1, 2, 6, 6)]),
    "globalaveragepool": ([_node("GlobalAveragePool", ["x"])], {}, [_x(2, 3, 4, 5)]),
    "flatten": ([_node("Flatten", ["x"], axis=2)], {}, [_x(2, 3, 4, 5)]),
    "reshape": ([_node("Reshape", ["x", "s"])], {"s": np.array([0, -1, 5], np.int64)},
                [_x(2, 3, 4, 5)]),
    "transpose-perm": ([_node("Transpose", ["x"], perm=[0, 2, 1])], {}, [_x(2, 3, 4)]),
    "transpose-default": ([_node("Transpose", ["x"])], {}, [_x(2, 3, 4)]),
    "concat": ([_node("Concat", ["x", "c"], axis=-1)], {"c": _x(2, 2)}, [_x(2, 3)]),
    "squeeze-attr": ([_node("Squeeze", ["x"], axes=[1])], {}, [_x(2, 1, 3, 1)]),
    "squeeze-input": ([_node("Squeeze", ["x", "a"])], {"a": np.array([-1], np.int64)},
                      [_x(2, 1, 3, 1)]),
    "squeeze-omitted": ([_node("Squeeze", ["x"])], {}, [_x(1, 3, 1)]),
    "unsqueeze-attr": ([_node("Unsqueeze", ["x"], axes=[0, 2])], {}, [_x(3, 4)]),
    "unsqueeze-input": ([_node("Unsqueeze", ["x", "a"])], {"a": np.array([1], np.int64)},
                        [_x(3, 4)]),
    "softmax": ([_node("Softmax", ["x"], axis=1)], {}, [_x(2, 5, 3)]),
    "max": ([_node("Max", ["x", "b", "c"])], {"b": _x(4, seed=7), "c": np.float32(0.1)},
            [_x(3, 4)]),
    "min": ([_node("Min", ["x", "b"])], {"b": _x(3, 4, seed=7)}, [_x(3, 4)]),
    "reducemax-input": ([_node("ReduceMax", ["x", "a"], keepdims=0)],
                        {"a": np.array([0], np.int64)}, [_x(2, 3)]),
    "reducemean-input": ([_node("ReduceMean", ["x", "a"])], {"a": np.array([-1], np.int64)},
                         [_x(2, 3)]),
    "reducesum-attr": ([_node("ReduceSum", ["x"], axes=[1, 2], keepdims=0)], {}, [_x(2, 3, 4)]),
    "reducesum-all": ([_node("ReduceSum", ["x"])], {}, [_x(2, 3, 4)]),
    "batchnorm": ([_node("BatchNormalization", ["x", "s", "b", "m", "v"], epsilon=1e-3)],
                  {"s": _x(3, seed=1), "b": _x(3, seed=2), "m": _x(3, seed=3),
                   "v": np.abs(_x(3, seed=4)) + 0.5}, [_x(2, 3, 4, 5)]),
    "shape-gather-cast": ([_node("Shape", ["x"], ["s"]),
                           _node("Gather", ["s", "i"], ["g"], axis=0),
                           _node("Cast", ["g"], ["y"], to=1)],
                          {"i": np.array([-1, 0], np.int64)}, [_x(2, 3, 4)]),
    "gather-axis1": ([_node("Gather", ["x", "i"], axis=1)],
                     {"i": np.array([[2, 0], [-1, 1]], np.int64)}, [_x(2, 4, 3)]),
    "cast-int": ([_node("Cast", ["x"], to=7)], {}, [3 * _x(2, 3)]),
    "slice": ([_node("Slice", ["x", "st", "en", "ax", "sp"])],
              {"st": np.array([1, 0], np.int64), "en": np.array([-1, 7], np.int64),
               "ax": np.array([2, 1], np.int64), "sp": np.array([1, 2], np.int64)},
              [_x(2, 8, 6)]),
    "slice-default-axes": ([_node("Slice", ["x", "st", "en"])],
                           {"st": np.array([0, 1], np.int64),
                            "en": np.array([1, 2**31 - 1], np.int64)}, [_x(3, 5)]),
    "slice-negative-step": ([_node("Slice", ["x", "st", "en", "ax", "sp"])],
                            {"st": np.array([4], np.int64), "en": np.array([0], np.int64),
                             "ax": np.array([1], np.int64), "sp": np.array([-2], np.int64)},
                            [_x(2, 6)]),
}


@pytest.mark.parametrize("case", list(OPS))
def test_op_matches_the_jax_executor(case):
    nodes, inits, args = OPS[case]
    inputs = [i for n in nodes for i in n["inputs"] if i and i not in inits
              and not any(i in m["outputs"] for m in nodes)]
    jm, tm = _pair(nodes, dict.fromkeys(inputs), inits=inits)
    _same(jm, tm, *args)


def test_every_op_of_the_jax_executor_is_covered():
    """The op names the JAX executor dispatches on, against the cases
    above (and its unsupported-op error)."""
    import inspect
    import re

    jax_ops = set(re.findall(r'op == "(\w+)"', inspect.getsource(J.OnnxJaxModel.__call__)))
    for group in re.findall(r"op in \(([^)]*)\)", inspect.getsource(J.OnnxJaxModel.__call__)):
        jax_ops |= set(re.findall(r'"(\w+)"', group))
    covered = {n["op"] for nodes, _, _ in OPS.values() for n in nodes}
    assert jax_ops == covered


def test_unsupported_op_raises_naming_it():
    _, tm = _pair([_node("LSTM", ["x"])], ["x"])
    with pytest.raises(NotImplementedError, match="LSTM"):
        tm(_x(2, 3))


def test_shapes_from_the_device_raise():
    """A Reshape whose shape lives on a device (here the meta device) raises
    instead of reading it back to the host."""
    with pytest.raises(NotImplementedError, match="Reshape shape"):
        T._run("Reshape", [torch.zeros(2, 3), torch.zeros(2, dtype=torch.int64,
                                                              device="meta")], {})


def test_integer_values_stay_on_the_host():
    tm = T.OnnxTorchModel.from_graph({"nodes": [], "initializers": {
        "w": _x(3), "s": np.array([1, -1], np.int64)}, "inputs": [], "outputs": []}, "cpu")
    assert tm.inits["w"].dtype == torch.float32 and tm.inits["s"].dtype == torch.int64


def _both_parse(path):
    return J.parse_onnx(path), T.parse_onnx(path)


def _same_graph(a, b):
    assert a["inputs"] == b["inputs"] and a["outputs"] == b["outputs"]
    assert [(n["op"], n["inputs"], n["outputs"]) for n in a["nodes"]] == [
        (n["op"], n["inputs"], n["outputs"]) for n in b["nodes"]]
    for na, nb in zip(a["nodes"], b["nodes"]):
        assert na["attrs"].keys() == nb["attrs"].keys()
        for k in na["attrs"]:
            np.testing.assert_array_equal(np.asarray(na["attrs"][k]), np.asarray(nb["attrs"][k]))
    assert a["initializers"].keys() == b["initializers"].keys()
    for k, v in a["initializers"].items():
        assert v.dtype == b["initializers"][k].dtype
        np.testing.assert_array_equal(v, b["initializers"][k])


def test_parser_reads_hand_serialized_bytes(tmp_path):
    """A graph of every attribute type written by ``chip_smoke.onnx_bytes``
    reads back the same on both sides, as what was written."""
    graph = {"inputs": ["x"], "outputs": ["y"], "initializers": {
        "w": _x(2, 3), "i": np.array([-3, 0, 2**40], np.int64), "h": np.arange(4, dtype=np.int32)},
        "nodes": [_node("Custom", ["x", "w", ""], ["y", "z"], f=0.25, i=-7, s="SAME_LOWER",
                        ints=[1, -2, 300], floats=[0.5, -1.5], t=np.array([1.5, 2.5], np.float32))]}
    path = tmp_path / "g.onnx"
    path.write_bytes(chip_smoke.onnx_bytes(graph))
    a, b = _both_parse(path)
    _same_graph(a, b)
    attrs = b["nodes"][0]["attrs"]
    assert attrs["f"] == 0.25 and attrs["i"] == -7 and attrs["s"] == "SAME_LOWER"
    assert attrs["ints"] == [1, -2, 300] and attrs["floats"] == [0.5, -1.5]
    np.testing.assert_array_equal(attrs["t"], [1.5, 2.5])
    for k, v in graph["initializers"].items():
        np.testing.assert_array_equal(b["initializers"][k], v)
    assert b["nodes"][0]["inputs"] == ["x", "w", ""] and b["nodes"][0]["outputs"] == ["y", "z"]


def test_parser_reads_typed_data_fields(tmp_path):
    """TensorProto's float_data (packed floats) and int64_data (packed
    varints, negatives as 64-bit two's complement), and INTS written one
    varint per field, by hand."""
    f = chip_smoke._field
    floats = f(1, 2) + f(2, 1) + f(8, "fd") + f(4, np.array([1.0, -2.0], "<f4").tobytes())
    ints = f(1, 3) + f(2, 7) + f(8, "id") + f(7, b"".join(chip_smoke._varint(v) for v in (5, -1, 0)))
    attr = f(1, "axes") + f(20, 7) + f(8, 2) + f(8, chip_smoke._varint(-1))
    node = f(1, "x") + f(2, "y") + f(4, "Squeeze") + f(5, attr)
    graph = f(1, node) + f(5, floats) + f(5, ints) + f(11, f(1, "x")) + f(11, f(1, "fd")) + f(
        12, f(1, "y"))
    path = tmp_path / "g.onnx"
    path.write_bytes(f(7, graph))
    a, b = _both_parse(path)
    _same_graph(a, b)
    assert b["inputs"] == ["x"]  # an input that is an initializer is not the graph's
    np.testing.assert_array_equal(b["initializers"]["fd"], [1.0, -2.0])
    np.testing.assert_array_equal(b["initializers"]["id"], [5, -1, 0])
    assert b["nodes"][0]["attrs"]["axes"] == [2, -1]


@pytest.mark.parametrize("which", ["p835", "p808", "sigmos"])
def test_seeded_graphs_from_files(tmp_path, which):
    """chip_smoke.py's phase 16 graphs, written and read back, through both
    executors at their shapes."""
    p835, p808 = chip_smoke.dnsmos_graphs(0)
    graph, x = {"p835": (p835, _x(1, 144160) * 0.1), "p808": (p808, _x(1, 900, 120)),
                "sigmos": (chip_smoke.sigmos_graph(0), np.abs(_x(1, 3, 40, 481)))}[which]
    path = tmp_path / f"{which}.onnx"
    path.write_bytes(chip_smoke.onnx_bytes(graph))
    _same_graph(*_both_parse(path))
    out = _same(J.OnnxJaxModel(path), T.OnnxTorchModel(path, "cpu"), x)[0]
    assert out.shape == ((1, 3) if which == "p835" else (1, 1) if which == "p808" else (1, 7))
    assert bool(((out >= 1) & (out <= 5)).all())
