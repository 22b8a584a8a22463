"""The ported slice as a whole: trajectory plans → moving render → loudness,
and a saved RIR bank → mixture step, through both packages on the CPU.

Tolerance: 1e-5 · max|ref| on rendered tracks (float32 FFT rounding at the
same nfft, through a loudness gain equal to 1e-3 LU); the bank bridge is
exact. Banks that each package renders itself differ as in
tests/test_torch_bank_render.py, and the tracks through them by up to
2.5e-5 · max|ref| (held to 4e-5).
"""

import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

import sonicsim_tpu.ops as J
import sonicsim_tpu_torch as T
from sonicsim_tpu.parallel import pad_moving_plans as j_pad
from sonicsim_tpu.parallel import render_mixture_sources as j_render
from sonicsim_tpu.sim.oracle import BankRirOracle, save_rir_bank
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SR = 16000
REL = 1e-5
# Rendered banks: the bank renderer's bound (tests/test_torch_bank_render.py).
BANK_ATOL, BANK_RTOL = 5e-5, 1e-4
# Tracks rendered through those banks: measured up to 2.5e-5 · max|ref|.
SLICE_REL = 4e-5


def _close(ours, ref):
    ref = np.asarray(ref)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=REL * np.abs(ref).max())


def test_moving_render_slice():
    """bench.py's pipeline at a small size: seeded waypoints, plans,
    batched fused segmented render, then LUFS normalisation."""
    t, n_src, p, c, l = 2 * SR, 3, 6, 2, 300
    plans = []
    for mod in (J, T):
        rng = np.random.default_rng(0)
        positions = np.cumsum(rng.uniform(0.2, 0.6, (p, 3)), axis=0)
        idx, w = mod.dynamic_interp_plan(positions, t, rng=rng)
        plans.append((mod.segment_plan(idx), rng))
    (off, le, max_seg), rng = plans[0]
    for a, b in zip(plans[1][0], plans[0][0]):
        np.testing.assert_array_equal(a, b)
    audio = rng.standard_normal((n_src, t)).astype(np.float32) * 0.1
    decay = np.exp(-np.linspace(0.0, 8.0, l, dtype=np.float32))
    rirs = rng.standard_normal((n_src, p, c, l)).astype(np.float32) * decay * 0.05
    ours = T.convolve_moving_segmented(
        torch.from_numpy(audio), torch.from_numpy(rirs), None, off, le, max_seg
    )
    ours = T.lufs_norm(ours, SR, -17.0)[0]
    for i in range(n_src):
        ref = J.convolve_moving_segmented(
            jnp.asarray(audio[i]), jnp.asarray(rirs[i]), None,
            jnp.asarray(off), jnp.asarray(le), max_seg,
        )
        _close(ours[i], J.lufs_norm(ref, SR, -17.0)[0])


def test_bank_to_mixture_slice(tmp_path):
    """A float16 bank saved by the JAX package loads into the port
    unchanged, and both render the same mixture from it."""
    rng = np.random.default_rng(1)
    t, c, l = SR, 2, 256
    rirs = (rng.standard_normal((3, 4, c, l)) * 0.05).astype(np.float16)
    rirs[..., 0] = 1.0
    path = tmp_path / "bank.npz"
    save_rir_bank(path, rirs, rng.uniform(0, 5, (3, 3)), rng.uniform(0, 5, (4, 3)),
                  sample_rate=SR, scene=np.asarray("room"))
    bank = T.load_rir_bank(path)
    ref_bank = BankRirOracle(path)._data
    assert bank["sample_rate"] == SR and bank["rirs"].dtype == np.float32
    for k in ref_bank:
        np.testing.assert_array_equal(bank[k], ref_bank[k])
    on_cpu = T.to_torch({"bank": bank, "rows": [bank["rirs"][0]]}, "cpu")
    assert on_cpu["bank"]["sample_rate"] == SR
    assert torch.equal(on_cpu["rows"][0], torch.from_numpy(bank["rirs"][0]))

    # Two moving speakers, each along the receivers of one source row.
    speech = (rng.standard_normal((2, t)) * 0.1).astype(np.float32)
    banks, weights, offs, lens = [], [], [], []
    for s in range(2):
        traj = np.cumsum(rng.uniform(0.3, 1.0, (4, 3)), axis=0)
        idx, w = T.dynamic_interp_plan(traj, t, rng=rng)
        o, le, _ = T.segment_plan(idx)
        banks.append(bank["rirs"][s])
        weights.append(w)
        offs.append(o)
        lens.append(le)
    banks_p, w_p, off_p, len_p, max_seg = T.pad_moving_plans(banks, weights, offs, lens)
    static_audio = (rng.standard_normal((2, t)) * 0.1).astype(np.float32)
    static_rirs = bank["rirs"][2, :2]
    lufs = (np.asarray([-17.0, -18.0], np.float32), np.asarray([-24.0, -29.0], np.float32))
    args = (speech, banks_p, None, off_p, len_p, max_seg, static_audio,
            static_rirs, *lufs, SR)
    ref_plans = j_pad(banks, weights, offs, lens)
    np.testing.assert_array_equal(ref_plans[0], banks_p)
    ours = T.render_mixture_sources(*args, device="cpu")
    ref = j_render(*args)
    for a, b in zip(ours, ref):
        _close(a, b)


def test_rendered_bank_to_mixture_slice():
    """The whole slice in each package: a room, its RIR banks rendered by
    the batched renderer, and the mixture step over them."""
    import dataclasses

    from sonicsim_tpu.sim.bank_render import render_rir_banks as j_banks
    from sonicsim_tpu.sim.channels import ChannelModel
    from sonicsim_tpu.sim.image_source import ShoeboxRoom
    from sonicsim_tpu.sim.oracle import SyntheticRirOracle

    ref_oracle = SyntheticRirOracle(ShoeboxRoom((6.0, 3.0, 5.0), absorption=0.4),
                                    n_bands=8, max_order=2, seed=2)
    channel = ChannelModel("Binaural")
    oracle, ch = T.bridge.sim_from_fields(dataclasses.asdict(ref_oracle),
                                          dataclasses.asdict(channel), device="cpu")
    rng = np.random.default_rng(4)
    ways = [list(rng.uniform([1, 1, 1], [5, 2.5, 4], (4, 3))) for _ in range(2)]
    ways.append(list(rng.uniform([1, 1, 1], [5, 2.5, 4], (2, 3))))
    mic = [np.array([3.0, 1.5, 2.5])]
    ref_banks = j_banks(ref_oracle, ways, mic, channel)
    banks = T.sim.render_rir_banks(oracle, ways, mic, ch, out_device=True)
    for a, b in zip(banks, ref_banks):
        np.testing.assert_allclose(a.numpy(), b, rtol=BANK_RTOL,
                                   atol=BANK_ATOL * np.abs(b).max())

    t = SR
    speech = (rng.standard_normal((2, t)) * 0.1).astype(np.float32)
    static_audio = (rng.standard_normal((2, t)) * 0.1).astype(np.float32)
    weights, offs, lens = [], [], []
    for w in ways[:2]:
        idx, wt = T.dynamic_interp_plan(np.asarray(w), t, rng=rng)
        o, le, _ = T.segment_plan(idx)
        weights.append(wt)
        offs.append(o)
        lens.append(le)
    lufs = (np.asarray([-17.0, -18.0], np.float32), np.asarray([-24.0, -29.0], np.float32))
    plans = T.pad_moving_plans([b[:, 0] for b in banks[:2]], weights, offs, lens)
    ours = T.render_mixture_sources(speech, plans[0], None, *plans[2:], static_audio,
                                    banks[2][:, 0], *lufs, SR, device="cpu")
    ref_plans = j_pad([b[:, 0] for b in ref_banks[:2]], weights, offs, lens)
    ref = j_render(speech, ref_plans[0], None, *ref_plans[2:], static_audio,
                   ref_banks[2][:, 0], *lufs, SR)
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=SLICE_REL * np.abs(b).max())


def test_port_imports_no_jax(tmp_path):
    """Importing the port and its ``sim`` subpackage, and running a small
    bank render, moving render, mixture step and ``generate_split`` on the
    CPU, then the serving CLIs (``audio_test`` over the generated split and
    ``inference`` on one of its tracks) from the repo's ConvTasNet YAML
    config with ``--device cpu``, loads neither jax nor the JAX package."""
    code = """
import sys
import numpy as np
import torch
import sonicsim_tpu_torch as T
import sonicsim_tpu_torch.sim as S

oracle = S.SyntheticRirOracle(S.ShoeboxRoom((5.0, 3.0, 4.0)), n_bands=4, max_order=1,
                              device="cpu")
bank = S.render_rir_bank(oracle, [np.array([1.0, 1.5, 1.0])], [np.array([3.0, 1.5, 2.0])],
                         S.ChannelModel("Binaural"))
assert bank.shape[:3] == (1, 1, 2) and np.isfinite(bank).all()

rng = np.random.default_rng(0)
t = 8000
idx, w = T.dynamic_interp_plan(np.cumsum(rng.uniform(0.3, 1, (4, 3)), 0), t, rng=rng)
off, le, ms = T.segment_plan(idx)
x = torch.from_numpy(rng.standard_normal(t).astype(np.float32))
r = torch.from_numpy(rng.standard_normal((4, 2, 64)).astype(np.float32))
out = T.convolve_moving_segmented(x, r, None, off, le, ms)
bp, wp, op, lp, m = T.pad_moving_plans([r.numpy()], [w], [off], [le])
mov, sta = T.render_mixture_sources(x[None].numpy(), bp, None, op, lp, m,
                                    x[None].numpy(), r[0:1].numpy(),
                                    np.float32([-17]), np.float32([-24]), 16000,
                                    device="cpu")
assert out.shape == (2, t) and mov.shape == (1, 2, t) and sta.shape == (1, 2, t)

from pathlib import Path
from sonicsim_tpu_torch.dataset import generate_split, scan_audio_lengths
from sonicsim_tpu_torch.utils import write_wav

root = Path(sys.argv[1])
dirs = []
for name in ("a", "b", "c", "noise", "music"):
    (root / name).mkdir()
    write_wav(root / name / "x.wav", rng.standard_normal(6000).astype(np.float32) * 0.1, 16000)
    dirs.append(str(root / name))
produced = generate_split(
    lambda n: S.Scene.synthetic(room=n, channel_type="Mono", max_order=1, device="cpu"),
    ["r"], dirs[:3], scan_audio_lengths(dirs[3]), scan_audio_lengths(dirs[4]),
    root / "out", duration=1.0)
assert len(produced) == 1 and (produced[0] / "json_data.json").exists()

from sonicsim_tpu_torch.models import save_model
from sonicsim_tpu_torch.scripts import audio_test, inference
from sonicsim_tpu_torch.utils import instantiate, load_config, save_config

cfg = load_config("configs/separation/convtasnet.yaml")
cfg["model"].update(N=16, L=16, B=8, H=16, X=1, R=1)
cfg["exp"] = {"dir": str(root / "exp"), "name": "ctn"}
cfg["datas"]["test_dir"] = str(root / "out")
save_model(instantiate(cfg["model"], device="cpu"), root / "exp" / "ctn" / "best_model.pkl")
save_config(cfg, root / "cfg.yaml")
res = audio_test.main(["--conf_dir", str(root / "cfg.yaml"), "--device", "cpu"])
assert res["spans"] == 1 and np.isfinite(res["final"]["si-snr"]), res
inference.main(["--model_path", str(root / "exp" / "ctn" / "best_model.pkl"), "--mix",
                str(produced[0] / "moving_audio_1.wav"), "--out_dir", str(root / "sep"),
                "--device", "cpu"])
assert (root / "sep" / "s2_est.wav").exists()
loaded =sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "sonicsim_tpu"))
assert not loaded, loaded
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"  # the CLIs print before it


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import sonicsim_tpu\b|from sonicsim_tpu\b)")
    files = [*(ROOT / "sonicsim_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    assert len(files) >= 9
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1) if pat.match(line)]
    assert not bad, bad
