"""Which operation of a separation model's float32 train step loses
precision (ROADMAP C12): one step of chip_smoke.py's phase 15 (full width,
seeded weights, the card test's seeded noise batch) under a dispatch mode
that recomputes every non-mutating float32 operation from the same inputs
in float64 on the same device, and keeps, per operation and argument
shapes, the largest output error as a share of max|float64 output|. Prints
the operations the card computes furthest from float64 (cuDNN as
configured) beside the same operations with cuDNN off and on the CPU, and
those furthest over the CPU's distance. On the card:

    python tests/op_precision_probe.py mossformer mossformer2

``--small`` runs it at the tests' small widths with the CPU in the card's
place.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def probe_step(fresh, dev, xb, yb) -> dict:
    """Each operation of one step on ``dev`` (by name, output and argument
    shapes): the largest distance of its float32 outputs from their float64
    recomputation, as a share of max|out64|, and its number of calls."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten, tree_map

    worst: dict = {}

    def up(t):
        return t.double() if isinstance(t, torch.Tensor) and t.dtype == torch.float32 else t

    class Probe(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func._schema.is_mutable or func is torch.ops.aten._to_copy.default:
                return out
            flat = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
            if not flat or any(t.dtype != torch.float32 for t in flat):
                return out
            try:
                ref = func(*tree_map(up, args), **tree_map(up, kwargs))
            except RuntimeError:
                return out
            for k, (a, b) in enumerate(zip(flat, [t for t in tree_flatten(ref)[0]
                                                 if isinstance(t, torch.Tensor)])):
                scale = float(b.abs().max()) if b.numel() else 0.0
                if not scale:
                    continue
                share = float((a.double() - b).abs().max()) / scale
                shapes = [tuple(t.shape) for t in tree_flatten(args)[0]
                          if isinstance(t, torch.Tensor)]
                key = f"{func.__name__}[{k}] {shapes}"
                if func in (torch.ops.aten.convolution.default,
                            torch.ops.aten.convolution_backward.default):
                    key += f" groups {args[8] if len(args) == 9 else args[9]}"
                s, n = worst.get(key, (0.0, 0))
                worst[key] = (max(s, share), n + 1)
            return out

    _, step = fresh(dev)
    with Probe():
        step(xb.to(dev), yb.to(dev))
    return worst


def main(stems, small: bool, top: int):
    import torch

    if small:
        device, smi = torch.device("cpu"), "CPU"
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        from test_torch_sep_train import CASES
        models = {name: cfg for name, cfg in CASES.values()}
        xb, yb = cs.c12_test_batch((2, 1200), (2, 2, 1200))
    else:
        device, smi, _ = cs.phase_env()
        models = cs.ZOO_MODELS
        xb, yb = cs.c12_test_batch((2, 8000), (2, 2, 8000))
    for stem in stems:
        name = cs.SEP_OPTIMIZERS[stem][0]
        weights = cs.seeded_zoo(name, models[name], 0).state_dict()
        fresh = cs.sep_train_fresh(stem, weights, dict(cs.SEP_TRAIN, models=models))
        sides = {}
        for label, dev, cudnn in (("card", device, True), ("cuDNN off", device, False),
                                  ("CPU", torch.device("cpu"), True)):
            enabled = torch.backends.cudnn.enabled
            torch.backends.cudnn.enabled = cudnn
            try:
                sides[label] = probe_step(fresh, dev, xb, yb)
            finally:
                torch.backends.cudnn.enabled = enabled
        card = sides["card"]

        def row(k):
            return (f"{k} x{card[k][1]}: " + " / ".join(
                f"{sides[s][k][0]:.3g}" if k in sides[s] else "-" for s in sides))

        by_share = sorted(card, key=lambda k: -card[k][0])[:top]
        by_ratio = sorted((k for k in card if k in sides["CPU"] and card[k][0] > 1e-6),
                          key=lambda k: -card[k][0] / max(sides["CPU"][k][0], 1e-12))[:top]
        for what, keys in (("furthest from float64", by_share),
                           ("furthest over the CPU's distance", by_ratio)):
            print(f"probe[{stem}, B=2 x {xb.shape[-1] / cs.SR:g} s of seeded noise, {what}]: "
                  f"float32 vs float64 per operation, of max|out64|, card / cuDNN off / CPU: "
                  + "; ".join(row(k) for k in keys) + f"; {smi}", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stems", nargs="+", choices=sorted(cs.SEP_OPTIMIZERS))
    ap.add_argument("--small", action="store_true", help="the tests' widths, on the CPU")
    ap.add_argument("--top", type=int, default=15)
    t0 = time.time()
    a = ap.parse_args()
    main(a.stems, a.small, a.top)
    print(f"{time.time() - t0:.1f} s", flush=True)
