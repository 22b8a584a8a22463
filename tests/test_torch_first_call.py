"""The first vectorised float32 math call on the CPU (ROADMAP C9).

In a fresh process, the first multithreaded ``torch.sqrt`` of a float32 CPU
tensor (exp, log, sin and pow alike) can return one OpenMP thread's share
of the tensor with a relative error up to 3.2e-4; a second call is exact.
Importing ``sonicsim_tpu_torch`` makes one single-threaded call first,
after which every call is exact. The test runs 64 fresh interpreters that
import the port and holds each one's first multithreaded sqrt to its
second, bit for bit: at the rate the bare interpreter shows on an 8-core
host (108 of 2,000, ROADMAP C9), a port without that call passes it in
0.946^64 ≈ 3% of runs.

As a script it counts the fresh processes whose first call differs from
their second: bare, with the port's import, and bare with MKL's code path
pinned (``MKL_CBWR=COMPATIBLE``):
``python tests/test_torch_first_call.py --runs 2000 --workers 4 --modes bare port bare-cbwr``.
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# One item per OpenMP thread on an 8-core host, as the bank's geometry is.
CHECK = """
import sys
import numpy as np
import torch
if sys.argv[1] == "port":
    import sonicsim_tpu_torch  # noqa: F401
x = torch.from_numpy(np.random.default_rng(0).uniform(1, 9000, (8, 5832)).astype(np.float32))
first, second = torch.sqrt(x), torch.sqrt(x)
print(float(((first - second) / second).abs().max()))
"""


# Each mode: whether the interpreter imports the port, and its environment.
MODES = {"bare": ("bare", {}), "port": ("port", {}),
         "bare-cbwr": ("bare", {"MKL_CBWR": "COMPATIBLE"})}


def first_call_errors(runs: int, workers: int, mode: str) -> list[float]:
    """Fresh interpreters, ``workers`` at a time: each one's largest
    relative distance of its first sqrt from its second."""
    arg, extra = MODES[mode]
    env = dict(os.environ, **extra)
    errors = []
    for start in range(0, runs, workers):
        procs = [subprocess.Popen([sys.executable, "-c", CHECK, arg], cwd=ROOT, env=env,
                                  stdout=subprocess.PIPE, text=True)
                 for _ in range(min(workers, runs - start))]
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out
            errors.append(float(out.strip().splitlines()[-1]))
    return errors


def test_first_call_after_import_is_exact():
    assert first_call_errors(runs=64, workers=8, mode="port") == [0.0] * 64


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=360)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--modes", nargs="+", choices=list(MODES), default=["bare", "port"])
    args = ap.parse_args()
    for mode in args.modes:
        errors = first_call_errors(args.runs, args.workers, mode)
        print(f"{mode}: {sum(e > 0 for e in errors)} of {args.runs} fresh processes had a first "
              f"sqrt that differs from the second, by at most {max(errors):.3g} of it", flush=True)
