"""How far a full-width enhancement model's float32 gradients lie from its
float64 ones on the CPU, each on its own branch at every kinked activation
and with the float32 pass on float64's branch (``chip_smoke._kink_tape``).

One backward of the config's loss from chip_smoke.py's seeded weights, on
B=2 x 1 s of a seeded AM tone with noise (target) and more noise (mixture),
at each CPU thread count given; distances as a share of max|g64|:

    python tests/kink_spread.py gagnet g2net dccrn frcrn --threads 1 2 4 8
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from sonicsim_tpu_torch.models import get  # noqa: E402

SR = 16000


def batch():
    """(mixture, target), each (2, SR) float32: an AM tone with a 0.01 noise
    floor, and the mixture 0.05 noise above it."""
    rng = np.random.default_rng(1)
    t = np.arange(SR) / SR

    def tone():
        f0, fm = rng.uniform(120, 400), rng.uniform(2, 6)
        return (0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.3 * np.sin(2 * np.pi * fm * t))
                + 0.01 * rng.standard_normal(SR))

    y = np.stack([tone(), tone()]).astype(np.float32)
    x = (y + 0.05 * rng.standard_normal(y.shape)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def grads(stem, weights, x, y, dtype, tape, flips):
    name, args = chip_smoke.ENH_MODELS[stem]
    loss_fn = chip_smoke._instantiate_loss(chip_smoke.ENH_LOSSES[stem][0])
    model = get(name)(**args, device="cpu")
    model.load_state_dict(weights)
    model.to(dtype)
    if tape is not None:
        chip_smoke._kink_tape(model, tape, flips)
    loss_fn(model(x.to(dtype)), y.to(dtype)).backward()
    return {n: p.grad.double() for n, p in model.named_parameters() if p.grad is not None}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stems", nargs="+", choices=list(chip_smoke.ENH_MODELS))
    ap.add_argument("--threads", nargs="+", type=int, default=[torch.get_num_threads()])
    args = ap.parse_args(argv)
    x, y = batch()
    default = torch.get_num_threads()
    for stem in args.stems:
        name, model_args = chip_smoke.ENH_MODELS[stem]
        weights = chip_smoke.seeded_zoo(name, model_args, 0).state_dict()
        tape: list = []
        g64 = grads(stem, weights, x, y, torch.float64, tape, None)
        top = max(float(g.abs().max()) for g in g64.values())

        def dist(g):
            return max(float((g[n] - g64[n]).abs().max()) for n in g64) / top

        for n in args.threads:
            torch.set_num_threads(n)
            try:
                own = dist(grads(stem, weights, x, y, torch.float32, None, None))
                flips = dict(n=0, rel=0.0)
                replayed = dist(grads(stem, weights, x, y, torch.float32, tape, flips))
            finally:
                torch.set_num_threads(default)
            print(f"{stem}: {n} threads, float32 from float64 {own:.3g} of max|g64| on its own "
                  f"branches, {replayed:.3g} on float64's ({len(tape)} kinked activation calls, "
                  f"{flips['n']} elements sent apart, within {flips['rel']:.3g}·max|x| of 0)",
                  flush=True)


if __name__ == "__main__":
    main()
