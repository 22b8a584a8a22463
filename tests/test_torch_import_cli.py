"""The port's checkpoint-import CLI against the JAX package's, on the CPU.

Seeded flax weights at small widths go through the bridge
(``models.base.to_state_dict``: the reference's parameter names) and
``torch.save`` into a reference-style ``.pth`` ({"model_name",
"state_dict", "model_args"}, whose ``model_args`` are the reference
constructor's plus its bookkeeping ``n_src``). Both CLIs convert it:
scripts/import_checkpoint.py in this process, ``python -m
sonicsim_tpu_torch.scripts.import_checkpoint`` in a subprocess where
``jax``, ``flax``, ``optax`` and ``sonicsim_tpu`` cannot be imported. The
packs must be equal leaf for leaf, bit for bit: ``model_name``,
``model_args`` and every array of ``state_dict`` with its dtype.

ConvTasNet, TDANet, DCCRN and FRCRN (the last three in their reference
quirk mode), and the override rules: ``--arg`` values of each type and
``--model``. A bidirectional DPRNN's packs differ, as ROADMAP C10 says:
the JAX converter maps DPRNN's LSTMs as unidirectional only
(sonicsim_tpu/models/torch_import.py:183), so its pack lacks each LSTM's
reverse cell, which the port's holds; every other leaf is equal.
"""

import importlib.util
import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.models import base as TB
from sonicsim_tpu_torch.scripts.import_checkpoint import parse_value

from test_torch_enh_models import SMALL as ENH_SMALL
from test_torch_zoo_models import SMALL as ZOO_SMALL
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
QUIRK = ("TDANet", "DCCRN", "FRCRN")
CONVTASNET = dict(N=32, L=16, B=16, H=32, P=3, X=2, R=1)
# id: (model, small width, extra CLI flags)
CASES = {
    "convtasnet": ("ConvTasNet", CONVTASNET, []),
    "tdanet": ("TDANet", ZOO_SMALL["TDANet"], []),
    "dccrn": ("DCCRN", ENH_SMALL["DCCRN"], []),
    "frcrn": ("FRCRN", ENH_SMALL["FRCRN"], []),
    "convtasnet-args": ("ConvTasNet", CONVTASNET,
                        ["--arg", "activate=sigmoid", "--arg", "sample_rate=8000",
                         "--arg", "causal=true"]),
    "tdanet-model": ("TDANet", ZOO_SMALL["TDANet"], ["--model", "TDANet"]),
    "dprnn-bidirectional": ("DPRNNTasNet", dict(ZOO_SMALL["DPRNNTasNet"], bidirectional=True),
                            []),
}
# The port's CLI with the JAX stack unimportable, over a JSON list of argv.
_PORT_RUNNER = """
import json, sys
for name in ("jax", "jaxlib", "flax", "optax", "sonicsim_tpu"):
    sys.modules[name] = None
from sonicsim_tpu_torch.scripts import import_checkpoint
for argv in json.loads(sys.argv[1]):
    import_checkpoint.main(argv)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "sonicsim_tpu")
            and sys.modules[m] is not None]
"""


def reference_pth(path: Path, name: str, cfg: dict, seed: int) -> None:
    """A reference checkpoint of ``name`` at ``cfg`` from seeded flax weights."""
    model = TM.get(name)(**cfg, **({"torch_compat": True} if name in QUIRK else {}),
                         device="cpu")
    args = model.model_args()
    params = chip_smoke.seeded_flax(TB.to_flax(name, model.state_dict(), args), seed)
    sd = TB.to_state_dict(name, params, args)
    ref_args = {k: v for k, v in args.items() if k != "torch_compat"}  # the port's own flag
    torch.save({"model_name": name, "model_args": dict(ref_args, n_src=2),
                "state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_import_checkpoint",
                                                  ROOT / "scripts" / "import_checkpoint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """Each case's two packs: {id: (JAX pack, port pack)}; the port's CLI
    lines."""
    root = tmp_path_factory.mktemp("import_cli")
    jcli, argvs = _jax_cli(), []
    for seed, (case, (name, cfg, flags)) in enumerate(CASES.items()):
        pth = root / f"{case}.pth"
        reference_pth(pth, name, cfg, seed)
        argv = sys.argv
        try:
            sys.argv = ["import_checkpoint.py", "--in", str(pth), "--out",
                        str(root / f"{case}_jax.pkl"), *flags]
            jcli.main()
        finally:
            sys.argv = argv
        argvs.append(["--in", str(pth), "--out", str(root / f"{case}_port.pkl"), *flags,
                      "--device", "cpu"])
    r = subprocess.run([sys.executable, "-c", _PORT_RUNNER, json.dumps(argvs)], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = {}
    for case in CASES:
        with open(root / f"{case}_jax.pkl", "rb") as f, open(root / f"{case}_port.pkl", "rb") as g:
            out[case] = (pickle.load(f), pickle.load(g))
    return out, r.stdout.splitlines()


def _leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _equal_leaves(a: dict, b: dict) -> None:
    for path in a:
        x, y = a[path], b[path]
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), path


@pytest.mark.parametrize("case", [c for c in CASES if not c.startswith("dprnn")])
def test_packs_are_equal_leaf_for_leaf(packs, case):
    (jax_pack, port_pack), lines = packs[0][case], packs[1]
    name = CASES[case][0]
    assert f"imported {name} -> " in "\n".join(lines)
    assert sorted(jax_pack) == sorted(port_pack)
    assert jax_pack["model_name"] == port_pack["model_name"] == name
    assert jax_pack["model_args"] == port_pack["model_args"]
    assert "n_src" not in port_pack["model_args"]
    if name in QUIRK:
        assert port_pack["model_args"]["torch_compat"] is True
    a, b = _leaves(jax_pack["state_dict"]), _leaves(port_pack["state_dict"])
    assert sorted(a) == sorted(b)
    _equal_leaves(a, b)


def test_overrides_reach_the_pack(packs):
    args = packs[0]["convtasnet-args"][1]["model_args"]
    assert (args["activate"], args["sample_rate"], args["causal"]) == ("sigmoid", 8000, True)


def test_bidirectional_dprnn_differs_as_c10_says(packs):
    jax_pack, port_pack = packs[0]["dprnn-bidirectional"]
    assert jax_pack["model_args"] == port_pack["model_args"]
    assert port_pack["model_args"]["bidirectional"] is True
    a, b = _leaves(jax_pack["state_dict"]), _leaves(port_pack["state_dict"])
    missing = set(b) - set(a)
    assert set(a) < set(b) and missing
    assert all("/OptimizedLSTMCell_1/" in p for p in missing)  # each LSTM's reverse cell
    _equal_leaves(a, b)


@pytest.mark.parametrize("text", ["3", "-2", "2.5", "1e-3", "true", "False", "gLN", "relu6"])
def test_values_parse_as_the_jax_cli_parses_them(text):
    want = _jax_cli()._parse_val(text)
    got = parse_value(text)
    assert type(got) is type(want) and got == want
