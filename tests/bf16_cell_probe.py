"""Where ``bf16_lstm_scan`` parts from its plain version, on the card.

At SkiM's shape (642 rows, 128 units, two directions) on seeded inputs
(projections N(0, 1), W_hh N(0, 1/H), zero and injected carries), after
one step and after 250: the kernel, the plain version (its dot a float32
matmul) and the plain version with its dot taken in float64 and rounded
once to float32, each against the others (rel-L2 of the outputs and of the
final h and c, and the share of outputs whose bfloat16 differs). Then the
kernel's, the plain version's and cuDNN's bf16 LSTM layer's CUDA-event
medians. One JSON line per reading.

    python tests/bf16_cell_probe.py

Needs the card; imports neither jax nor the JAX package.
"""

import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sonicsim_tpu_torch.ops import lstm_cell  # noqa: E402

N, H, DIRS = 642, 128, 2


def plain_f64_dot(xp, w_hh, bias, h0, c0, reverse):
    """``bf16_lstm_scan_ref`` with ``h·W_hhᵀ`` in float64, rounded once to
    float32: the correctly rounded dot."""
    rnd, sig = lstm_cell._rnd, lstm_cell._sigmoid
    n, k, _ = xp.shape
    dirs, gates, hidden = w_hh.shape
    w_t = w_hh.double().transpose(1, 2)
    b = bias.float()[:, None, :]
    x = xp.float().reshape(n, k, dirs, gates)
    h, c = h0.float(), c0.float()
    out = torch.empty(n, k, dirs, hidden, dtype=torch.bfloat16, device=xp.device)
    lanes = torch.arange(dirs, device=xp.device)
    for step in range(k):
        at = torch.tensor([k - 1 - step if r else step for r in reverse], device=xp.device)
        dot = torch.bmm(h.double(), w_t).float()
        z = rnd(rnd(rnd(dot) + b) + x[:, at, lanes].transpose(0, 1))
        zi, zf, zg, zo = z.split(hidden, dim=-1)
        c = rnd(rnd(sig(zf) * c) + rnd(sig(zi) * rnd(torch.tanh(zg))))
        h = rnd(sig(zo) * rnd(torch.tanh(c)))
        out[:, at, lanes] = h.transpose(0, 1).to(torch.bfloat16)
    return out.reshape(n, k, dirs * hidden), h.to(torch.bfloat16), c.to(torch.bfloat16)


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def median_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)

    xp = bf(rng.standard_normal((N, 250, DIRS * 4 * H)))
    w_hh = bf(rng.standard_normal((DIRS, 4 * H, H)) / np.sqrt(H))
    bias = bf(0.1 * rng.standard_normal((DIRS, 4 * H)))
    zeros = bf(np.zeros((DIRS, N, H)))
    carries = {"zero": (zeros, zeros),
               "injected": (bf(np.tanh(rng.standard_normal((DIRS, N, H)))),
                            bf(rng.standard_normal((DIRS, N, H))))}
    reverse = [False, True]
    for carry, (h0, c0) in carries.items():
        for k in (1, 250):
            args = (xp[:, :k].contiguous(), w_hh, bias, h0, c0, reverse)
            outs = {"kernel": lstm_cell.bf16_lstm_scan(*args),
                    "plain": lstm_cell.bf16_lstm_scan_ref(*args),
                    "plain_f64_dot": plain_f64_dot(*args)}
            torch.cuda.synchronize()
            for a, b in (("kernel", "plain"), ("kernel", "plain_f64_dot"),
                         ("plain", "plain_f64_dot")):
                x, y = outs[a], outs[b]
                print(json.dumps({"carry": carry, "steps": k, "pair": f"{a} vs {b}",
                                  "outputs": rel(x[0], y[0]), "h": rel(x[1], y[1]),
                                  "c": rel(x[2], y[2]),
                                  "flipped": float((x[0] != y[0]).float().mean())}), flush=True)
    args = (xp, w_hh, bias, zeros, zeros, reverse)
    layer = torch.nn.LSTM(64, H, batch_first=True, bidirectional=True).to(dev).bfloat16()
    layer.flatten_parameters()
    x_layer = bf(rng.standard_normal((N, 250, 64)))
    with torch.inference_mode():
        times = {"kernel_ms": median_ms(lambda: lstm_cell.bf16_lstm_scan(*args)),
                 "plain_ms": median_ms(lambda: lstm_cell.bf16_lstm_scan_ref(*args), warmup=1),
                 "cudnn_bf16_lstm_ms": median_ms(lambda: layer(x_layer, (zeros, zeros)))}
    print(json.dumps({"device": torch.cuda.get_device_name(0), **times}), flush=True)


if __name__ == "__main__":
    main()
