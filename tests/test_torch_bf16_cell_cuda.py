"""The bf16 LSTM cell kernels (``csrc/bf16_lstm.cu``) on the card against
their plain versions (``ops.lstm_cell``'s ``*_ref``) on the same card.

* the forward, both variants (inference, and training, which also writes
  the gates and c), at a small shape (6 rows, 24 steps, 32 units), both directions,
  from a zero and from a seeded carry, and every hidden width the kernels
  have an instance of, uni- and bidirectional;
* at SkiM's full shape (642 rows, 250 steps, 128 units, two directions: the
  first SegLSTM of skim.yaml on 10 s of audio), from the inputs the model's
  bf16 forward gives the kernel and from injected carries;
* the training forward (``bf16_lstm_scan_train_kernel``) at SkiM's B=2 x
  4 s training shape (516 rows, 250 steps, 128 units, two directions), at
  a row count that is not a multiple of its 8-row tiles (517), at one row,
  and at more tiles than the card has SMs (1,100 rows): y, h, c, the kept
  gates and cells within ``REL`` of the plain version, the bit-equal share
  printed; and the serving forward's outputs on seeded inputs bit-equal to
  the earlier source's (``SERVING_SHA256``, which
  ``tests/bf16_cell_probe.py --train-variants`` prints for a source);
* the backward at the small shapes, every width and SkiM's, on the
  training forward's own gates and c;
* the backward at row counts that fill no tile, one and one and a bit (5,
  8, 9, 17, 33), every direction mask;
* the running sum (weights and the windowed bias sum over 70 and 1,100
  rows), on a bfloat16 ``dz`` (the bf16 cell's) and a float32 one (a
  float32 carry's), from zero and from given accumulators, both direction
  orders: bit-equal to its plain version, which does the same arithmetic
  in the same order;
* ``f32_carry_lstm``'s gradients (a float32-carry layer of a bf16 train
  step: cuDNN, the step products, the running sum) on the card against the
  CPU's, and walked in chunks of steps bit-equal to one walk;
* ``bf16_lstm``'s gradients on the card against the CPU's (the plain
  versions), every cotangent;
* a failed build raises, and so does a width the kernels have no instance
  of.

Tolerance rel-L2 1e-3 (``chip_smoke.py`` phase 22's) for the forward
scans: their dots run on the tensor cores in another summation order than
the plain version's float32 matmul, and a bfloat16 rounding that flips
carries through the recurrence. 5e-3 for the backward, 3x its readings
(up to 1.66e-3 at SkiM's shape, on dh0, the rounding of one dot over 512
terms): the same cause over four times as many terms, and the kernel's
dot is the closer of the two to an exact one (``tests/bf16_cell_probe.py
--variants``: 7.4e-4 against the plain version's 9.3e-4). 1e-2 for the
gradients card against CPU, which carry the forward's flips and the
backward's. The bit-equal share of each
output is printed. Imports neither jax nor the JAX package (the card's host
has neither); run with ``--noconftest``.
"""

import numpy as np
import pytest
import torch

from sonicsim_tpu_torch.ops import lstm_cell

REL = 1e-3
BACKWARD_REL = 5e-3
GRAD_REL = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16 LSTM cell kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def inputs(n, k, h, dirs, seed, carry, device):
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, torch.bfloat16)

    xp = bf(rng.standard_normal((n, k, dirs * 4 * h)))
    w_hh = bf(rng.standard_normal((dirs, 4 * h, h)) / np.sqrt(h))
    bias = bf(0.1 * rng.standard_normal((dirs, 4 * h)))
    if carry:
        h0, c0 = bf(np.tanh(rng.standard_normal((dirs, n, h)))), bf(rng.standard_normal((dirs, n, h)))
    else:
        h0 = c0 = bf(np.zeros((dirs, n, h)))
    return xp, w_hh, bias, h0, c0, [d == 1 for d in range(dirs)]


def hold(args, keep=False) -> list:
    name = "bf16_lstm_scan_train" if keep else "bf16_lstm_scan"
    before = lstm_cell.LAUNCHES[name]
    got = lstm_cell.bf16_lstm_scan(*args, keep=keep)
    torch.cuda.synchronize()
    assert lstm_cell.LAUNCHES[name] == before + 1
    ref = lstm_cell.bf16_lstm_scan_ref(*args, keep=keep)
    return compare(got, ref)


def compare(got, ref) -> list:
    assert all(g.dtype == r.dtype and g.shape == r.shape for g, r in zip(got, ref))
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)
    print("bit-equal:", [float((g == r).float().mean()) for g, r in zip(got, ref)])
    return [rel_l2(g, r) for g, r in zip(got, ref)]


def hold_backward(args) -> list:
    """The backward on the training forward's (plain version's) gates and c and
    seeded cotangents, against its plain version."""
    xp, w_hh, bias, h0, c0, reverse = args
    y, hn, cn, gates, c = lstm_cell.bf16_lstm_scan_ref(*args, keep=True)
    g = torch.Generator(device=xp.device).manual_seed(5)
    dy, dhn, dcn = (torch.randn(t.shape, generator=g, device=xp.device).bfloat16()
                    for t in (y, hn, cn))
    before = lstm_cell.LAUNCHES["bf16_lstm_scan_backward"]
    got = lstm_cell.bf16_lstm_scan_backward(dy, dhn, dcn, gates, c, w_hh, c0, reverse)
    torch.cuda.synchronize()
    assert lstm_cell.LAUNCHES["bf16_lstm_scan_backward"] == before + 1
    return compare(got, lstm_cell.bf16_lstm_scan_backward_ref(dy, dhn, dcn, gates, c, w_hh, c0,
                                                              reverse))


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [False, True], ids=["inference", "training"])
@pytest.mark.parametrize("carry", [False, True], ids=["zero", "seeded"])
@pytest.mark.parametrize("dirs", [1, 2])
def test_kernel_matches_plain_small(cuda_device, dirs, carry, keep):
    dists = hold(inputs(6, 24, 32, dirs, 3 + dirs, carry, cuda_device), keep)
    assert max(dists) <= REL, dists


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", lstm_cell.HIDDEN)
def test_every_hidden_width(cuda_device, hidden):
    args = inputs(21, 9, hidden, 2, hidden, True, cuda_device)
    dists = hold(args) + hold(args, keep=True)
    assert max(dists) <= REL, dists
    dists = hold_backward(args)
    assert max(dists) <= BACKWARD_REL, dists


@pytest.mark.cuda
@pytest.mark.parametrize("rows,steps", [(516, 250), (517, 64), (1, 64), (1100, 64)],
                         ids=["skim-train-516", "517", "1", "1100"])
def test_training_forward_rows(cuda_device, rows, steps):
    """The training forward at SkiM's training shape, a row count its 8-row
    tiles do not divide, one row, and more (tile, direction) pairs than
    SMs."""
    dists = hold(inputs(rows, steps, 128, 2, rows, True, cuda_device), keep=True)
    print("rel-L2 (y, hn, cn, gates, c):", dists)
    assert max(dists) <= REL, dists


# sha256 of the serving forward's outputs on ``serving_digest``'s inputs, as
# the source from before the training forward had its own kernel computed
# them on an NVIDIA H100 80GB HBM3: the serving kernel is unchanged.
SERVING_SHA256 = "266a08912fa8a8d44da37e5eb8823fe1b380cc3ca3c734e9bca0d8cefbc901b5"


def serving_digest(device) -> str:
    """sha256 of the serving forward's y, hn and cn bytes on seeded inputs
    (300 rows, 40 steps, 128 units, two directions, seeded carries)."""
    import hashlib

    got = lstm_cell.bf16_lstm_scan(*inputs(300, 40, 128, 2, 20, True, device))
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for t in got:
        digest.update(t.view(torch.int16).cpu().numpy().tobytes())
    return digest.hexdigest()


@pytest.mark.cuda
def test_serving_forward_is_unchanged(cuda_device):
    assert serving_digest(cuda_device) == SERVING_SHA256


@pytest.mark.cuda
@pytest.mark.parametrize("carry", [False, True], ids=["zero", "seeded"])
@pytest.mark.parametrize("dirs", [1, 2])
def test_backward_matches_plain_small(cuda_device, dirs, carry):
    dists = hold_backward(inputs(6, 24, 32, dirs, 7 + dirs, carry, cuda_device))
    assert max(dists) <= BACKWARD_REL, dists


@pytest.mark.cuda
@pytest.mark.parametrize("start", [False, True], ids=["from-zero", "from-accumulators"])
@pytest.mark.parametrize("dz_dtype", [torch.bfloat16, torch.float32], ids=["bf16-dz", "f32-dz"])
@pytest.mark.parametrize("rows", [70, 1100])
def test_running_sum_is_its_plain_version(cuda_device, rows, dz_dtype, start):
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    products = torch.randn(2, 9, 64, 40, generator=g, device=cuda_device)
    dz = torch.randn(rows, 9, 128, generator=g, device=cuda_device).to(dz_dtype)
    acc = (torch.randn(2, 64, 40, generator=g, device=cuda_device).bfloat16(),
           torch.randn(2, 64, generator=g, device=cuda_device).bfloat16()) if start else ()
    name = "bf16_running_sum_f32dz" if dz_dtype == torch.float32 else "bf16_running_sum"
    for reverse in ([False, True], [True, False]):
        before = lstm_cell.LAUNCHES[name]
        got = lstm_cell.bf16_running_sum(products, dz, reverse, *acc)
        torch.cuda.synchronize()
        assert lstm_cell.LAUNCHES[name] == before + 1
        ref = lstm_cell.bf16_running_sum_ref(products, dz, reverse, *acc)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [[False], [True], [False, True], [True, False]],
                         ids=["fwd", "rev", "fwd-rev", "rev-fwd"])
@pytest.mark.parametrize("rows", [5, 8, 9, 17, 33])
def test_backward_rows_and_direction_masks(cuda_device, rows, reverse):
    """Row counts that fill no tile, one, and one and a bit, each direction
    mask."""
    xp, w_hh, bias, h0, c0, _ = inputs(rows, 13, 32, len(reverse), rows, True, cuda_device)
    dists = hold_backward((xp, w_hh, bias, h0, c0, reverse))
    assert max(dists) <= BACKWARD_REL, dists


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32], ids=["bf16-in", "f32-in"])
@pytest.mark.parametrize("dirs", [1, 2])
def test_float32_carry_gradients_on_the_card_are_the_cpus(cuda_device, dirs, x_dtype,
                                                          monkeypatch):
    """``f32_carry_lstm`` (cuDNN's float32 recurrence, the step products,
    the running sum's float32-dz form) on the card against the CPU, and
    walked in chunks of 7 steps, bit-equal to one walk."""
    rng = np.random.default_rng(10 + dirs)
    n, k, c_in, h = 45, 20, 24, 32
    args = [rng.standard_normal((n, k, c_in)), 0.3 * rng.standard_normal((dirs, 4 * h, c_in)),
            0.3 * rng.standard_normal((dirs, 4 * h, h)), 0.3 * rng.standard_normal((dirs, 4 * h)),
            np.zeros((dirs, 4 * h)), np.tanh(rng.standard_normal((dirs, n, h))),
            rng.standard_normal((dirs, n, h))]
    cts = [rng.standard_normal((n, k, dirs * h)), rng.standard_normal((dirs, n, h)),
           rng.standard_normal((dirs, n, h))]
    reverse = [d == 1 for d in range(dirs)]

    def grads(dev):
        dts = [x_dtype] + [torch.bfloat16] * 4 + [torch.float32] * 2
        ts = [torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt).requires_grad_()
              for a, dt in zip(args, dts)]
        out = lstm_cell.f32_carry_lstm(*ts, reverse, True)
        torch.autograd.backward(out, [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                                      for a in cts])
        return [t.grad.cpu() for i, t in enumerate(ts) if i != 4]

    before = lstm_cell.LAUNCHES["bf16_running_sum_f32dz"]
    card = grads(cuda_device)
    assert lstm_cell.LAUNCHES["bf16_running_sum_f32dz"] == before + 1
    dists = compare(card, grads("cpu"))
    print("rel-L2 (x, W_ih, W_hh, bias, h0, c0):", dists)
    assert max(dists) <= GRAD_REL, dists
    monkeypatch.setattr(lstm_cell, "PRODUCTS_BUDGET", 7 * 4 * dirs * 4 * h * (h + c_in))
    chunked = grads(cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(chunked, card))


@pytest.mark.cuda
@pytest.mark.parametrize("dirs", [1, 2])
def test_layer_gradients_on_the_card_are_the_cpus(cuda_device, dirs):
    rng = np.random.default_rng(dirs)
    n, k, c_in, h = 37, 20, 24, 32
    args = [rng.standard_normal((n, k, c_in)), 0.3 * rng.standard_normal((dirs, 4 * h, c_in)),
            0.3 * rng.standard_normal((dirs, 4 * h, h)), 0.3 * rng.standard_normal((dirs, 4 * h)),
            np.tanh(rng.standard_normal((dirs, n, h))), rng.standard_normal((dirs, n, h))]
    cts = [rng.standard_normal((n, k, dirs * h)), rng.standard_normal((dirs, n, h)),
           rng.standard_normal((dirs, n, h))]
    grads = {}
    for dev in ("cpu", cuda_device):
        ts = [torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16).requires_grad_()
              for a in args]
        out = lstm_cell.bf16_lstm(*ts, [d == 1 for d in range(dirs)])
        torch.autograd.backward(out, [torch.from_numpy(np.asarray(a, np.float32)).to(
            dev, torch.bfloat16) for a in cts])
        grads[str(dev)] = [t.grad.cpu() for t in ts]
    dists = compare(grads[str(cuda_device)], grads["cpu"])
    print("rel-L2 (x, W_ih, W_hh, bias, h0, c0):", dists)
    assert max(dists) <= GRAD_REL, dists


def skim_inputs(device) -> tuple:
    """The kernel's arguments in skim.yaml's bf16 forward of 10 s of seeded
    noise on the card (``chip_smoke.seeded_zoo``'s weights)."""
    import chip_smoke
    from sonicsim_tpu_torch.scripts.common import make_forward

    model = chip_smoke.seeded_zoo("SkiMNet", chip_smoke.ZOO_MODELS["SkiMNet"], 0).to(device)
    seen, scan = [], lstm_cell.bf16_lstm_scan

    def record(*args, **kwargs):
        seen.append(args)
        return scan(*args, **kwargs)

    lstm_cell.bf16_lstm_scan = record
    try:
        x = 0.1 * torch.randn(1, 160000, generator=torch.Generator().manual_seed(0))
        make_forward(model, bf16=True)(x.to(device))
    finally:
        lstm_cell.bf16_lstm_scan = scan
    assert len(seen) == 1  # skim.yaml: the first SegLSTM alone has a bfloat16 carry
    return seen[0]


@pytest.mark.cuda
@pytest.mark.parametrize("carry", ["model", "injected"])
def test_kernel_matches_plain_at_skim_shape(cuda_device, carry):
    xp, w_hh, bias, h0, c0, reverse = skim_inputs(cuda_device)
    assert tuple(xp.shape) == (642, 250, 1024) and tuple(w_hh.shape) == (2, 512, 128)
    if carry == "injected":
        g = torch.Generator(device=cuda_device).manual_seed(1)
        h0 = torch.tanh(torch.randn(h0.shape, generator=g, device=cuda_device)).bfloat16()
        c0 = torch.randn(c0.shape, generator=g, device=cuda_device).bfloat16()
    args = (xp, w_hh, bias, h0, c0, reverse)
    dists = hold(args) + hold(args, keep=True)
    assert max(dists) <= REL, dists
    dists = hold_backward(args)
    assert max(dists) <= BACKWARD_REL, dists


@pytest.mark.cuda
def test_failed_build_and_unbuilt_width_raise(cuda_device, tmp_path, monkeypatch):
    args = inputs(4, 3, 32, 1, 0, False, cuda_device)
    with pytest.raises(ValueError, match="hidden width"):
        lstm_cell.bf16_lstm_scan(*inputs(4, 3, 24, 1, 0, False, cuda_device))
    bad = tmp_path / "bf16_lstm.cu"
    bad.write_text(lstm_cell.SOURCE.read_text() + "\nthis does not compile;\n")
    monkeypatch.setattr(lstm_cell, "SOURCE", bad)
    monkeypatch.setattr(lstm_cell, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        lstm_cell.bf16_lstm_scan(*args)
