#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

From the repository root, on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, one line each:

1. environment (torch, CUDA, triton, nvcc, the card);
2. build of the Hopper kernels from ``sonicsim_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   headline shapes and at the blocked path's short-segment shapes, with
   times (CUDA events, median of 20);
4. the headline render (12 sources x 60 s x 40 binaural 16,000-tap RIRs,
   the workload of ``bench.py``) through ``convolve_moving_segmented``,
   one source checked against the plain path in float64 on the CPU;
5. the mixture step (3 moving speakers + noise + music, 60 s, binaural)
   through ``render_mixture_sources`` in its fused and ``weights=`` forms,
   checked for finiteness, target loudness and agreement.

Then a JSON line of the kernels' numbers, the card's name and power limit as
``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero with no
result, as does a run with no CUDA device or outside the repository.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

SR = 16000
HEADLINE = dict(n_src=12, duration=60.0, p=40, c=2, l=16000, iters=5)
MIXTURE = dict(duration=60.0, p=40, c=2, l=16000, iters=3,
               speech_lufs=(-17.0, -17.0, -17.0), static_lufs=(-24.0, -29.0))
# The float64 CPU reference vs the card's float32 render (as the JAX
# package's tests hold the segmented conv to the dense one).
RTOL, ATOL = 1e-3, 1e-4
LUFS_TOL = 0.05  # LU
FORMS_ATOL = 1e-4  # fused vs weights= mixture forms
K2_ATOL = 1e-6
REPLACES = {
    "select_segments": "sonicsim_tpu/ops/pallas_kernels.py:140",
    "crossfade_combine": "sonicsim_tpu/ops/pallas_kernels.py:58",
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median_ms(fn, device, reps: int = 20, warmup: int = 3) -> float:
    """Median time of ``fn()`` in ms: CUDA events on the card, the host
    clock (after a synchronise) elsewhere."""
    import torch

    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_env():
    import torch

    check(torch.cuda.is_available(), "CUDA is not available")
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sonicsim_tpu_torch.ops import kernels

    props = torch.cuda.get_device_properties(0)
    nvcc = kernels._nvcc()
    nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True,
                            text=True, timeout=60).stdout.strip().splitlines()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    check(bool(smi), "nvidia-smi gave no card name and power limit")
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} triton {triton_v} "
          f"nvcc-on-PATH {shutil.which('nvcc')} nvcc {nvcc} "
          f"({nvcc_v[-1] if nvcc_v else '?'}) device {props} "
          f"count {torch.cuda.device_count()}", flush=True)
    return torch.device("cuda", 0), smi


def phase_build() -> None:
    from sonicsim_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    path = kernels.build(verbose=True)
    kernels._library()
    dt = time.perf_counter() - t0
    print(f"build: {path.name} in {dt:.3f} s", flush=True)


def headline_plan(cfg):
    """The bench.py workload, seed 0 (bench.py:176-198)."""
    from sonicsim_tpu_torch.ops import dynamic_interp_plan, segment_plan

    t = int(SR * cfg["duration"])
    p, c, l = cfg["p"], cfg["c"], cfg["l"]
    rng = np.random.default_rng(0)
    positions = np.cumsum(rng.uniform(0.2, 0.6, size=(p, 3)), axis=0)
    idx, w = dynamic_interp_plan(positions, t, rng=rng)
    offsets, lengths, max_seg = segment_plan(idx)
    audio = rng.standard_normal((cfg["n_src"], t)).astype(np.float32) * 0.1
    decay = np.exp(-np.linspace(0.0, 8.0, l, dtype=np.float32))
    rirs = (
        rng.standard_normal((cfg["n_src"], p, c, l)).astype(np.float32)
        * decay * 0.05
    )
    return audio, rirs, w, offsets, lengths, max_seg


def mixture_inputs(cfg):
    """Seeded synthetic mixture: 3 moving speakers with their own
    trajectories and decaying random banks, plus static noise and music."""
    from sonicsim_tpu_torch.ops import dynamic_interp_plan, segment_plan
    from sonicsim_tpu_torch.parallel import pad_moving_plans

    t = int(SR * cfg["duration"])
    p, c, l = cfg["p"], cfg["c"], cfg["l"]
    rng = np.random.default_rng(1)
    decay = np.exp(-np.linspace(0.0, 8.0, l)).astype(np.float32)
    banks, weights, offs, lens = [], [], [], []
    for _ in cfg["speech_lufs"]:
        traj = np.cumsum(rng.uniform(0.2, 0.6, (p, 3)), axis=0)
        bank = (rng.standard_normal((p, c, l)) * decay * 0.05).astype(np.float32)
        bank[:, :, 0] = 1.0  # direct path
        idx, w = dynamic_interp_plan(traj, t, rng=rng)
        o, le, _ = segment_plan(idx)
        banks.append(bank)
        weights.append(w)
        offs.append(o)
        lens.append(le)
    speech = (rng.standard_normal((len(banks), t)) * 0.1).astype(np.float32)
    static_audio = (rng.standard_normal((2, t)) * 0.1).astype(np.float32)
    static_rirs = (rng.standard_normal((2, c, l)) * decay * 0.05).astype(np.float32)
    static_rirs[:, :, 0] = 1.0
    banks_p, w_p, off_p, len_p, max_seg = pad_moving_plans(banks, weights, offs, lens)
    return dict(
        speech=speech, banks=banks_p, weights=w_p, offsets=off_p,
        lengths=len_p, max_seg=max_seg, static_audio=static_audio,
        static_rirs=static_rirs,
        speech_lufs=np.asarray(cfg["speech_lufs"], np.float32),
        static_lufs=np.asarray(cfg["static_lufs"], np.float32),
    )


def _kernel_case(device, tables, span, c, t, w, seed):
    """Random K1/K2 operands on ``device`` for (B, N) tables."""
    import torch

    off = torch.as_tensor(tables, device=device, dtype=torch.int32)
    off_al = off - off % 128
    bsz, n = off.shape
    g = torch.Generator(device=device).manual_seed(seed)
    combined = torch.randn((bsz, n, c, span), generator=g, device=device)
    conv = torch.randn((bsz, n, 2, c, span), generator=g, device=device)
    wt = torch.as_tensor(w, device=device, dtype=torch.float32).expand(bsz, t).contiguous()
    return off, off_al, combined, conv, wt


def phase_kernels(device, head, mix):
    """Each kernel against its plain version on the card, at the headline
    shapes and the blocked path's short-segment shapes."""
    from sonicsim_tpu_torch.ops import block_plan_sizes, kernels, moving_block_plan

    audio, rirs, w, offsets, lengths, max_seg = head
    n_src, t = audio.shape
    c = rirs.shape[2]
    cases = {"headline": (np.tile(offsets, (n_src, 1)),
                          max_seg + 128, w)}
    block, nb = block_plan_sizes(mix["max_seg"], t, mix["offsets"].shape[1])
    blocked = np.stack([
        moving_block_plan(o, le, t, block, nb)[0]
        for o, le in zip(mix["offsets"], mix["lengths"])
    ])
    d = np.diff(blocked, axis=1)
    check(int(d[d > 0].min()) < 8192,
          "the blocked case has no block shorter than 8192")
    cases["short"] = (blocked, block + 128, mix["weights"][0])
    results = {}
    for seed, (name, (tables, span, wc)) in enumerate(cases.items()):
        off, off_al, combined, conv, wt = _kernel_case(
            device, tables, span, c, t, wc, seed
        )
        k1 = lambda: kernels.select_segments(combined, off, off_al, t)  # noqa: E731
        p1 = lambda: kernels.select_segments_ref(combined, off, off_al, t)  # noqa: E731
        k2 = lambda: kernels.crossfade_combine(conv, wt, off, off_al, t)  # noqa: E731
        p2 = lambda: kernels.crossfade_combine_ref(conv, wt, off, off_al, t)  # noqa: E731
        e1 = float((k1() - p1()).abs().max())
        e2 = float((k2() - p2()).abs().max())
        sync(device)
        check(e1 == 0.0, f"select_segments differs from plain ({name}): {e1}")
        check(e2 <= K2_ATOL, f"crossfade_combine differs from plain ({name}): {e2}")
        ms = {
            "select_segments": (median_ms(k1, device), median_ms(p1, device), e1),
            "crossfade_combine": (median_ms(k2, device), median_ms(p2, device), e2),
        }
        results[name] = ms
        print(f"kernels[{name}]: B={off.shape[0]} N={off.shape[1]} C={c} "
              f"span={span} T={t} | "
              + " | ".join(f"{k} {v[0]:.4f} ms vs plain {v[1]:.4f} ms, "
                           f"max abs err {v[2]:.3g}" for k, v in ms.items()),
              flush=True)
    return results


def phase_headline(device, head, cfg):
    import torch

    from sonicsim_tpu_torch.bridge import to_torch
    from sonicsim_tpu_torch.ops import convolve_moving_segmented

    audio, rirs, _, offsets, lengths, max_seg = head
    x, r = to_torch((audio, rirs), device)

    def render():
        return convolve_moving_segmented(x, r, None, offsets, lengths, max_seg)

    out = render()  # warm-up (cuFFT plans)
    sync(device)
    times = []
    for _ in range(cfg["iters"]):
        t0 = time.perf_counter()
        out = render()
        sync(device)
        times.append(time.perf_counter() - t0)
    check(tuple(out.shape) == (audio.shape[0], rirs.shape[2], audio.shape[1]),
          f"headline output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "headline output not finite")
    ref = convolve_moving_segmented(
        torch.from_numpy(audio[0]).double(), torch.from_numpy(rirs[0]).double(),
        None, offsets, lengths, max_seg,
    )
    got = out[0].double().cpu()
    err = float((got - ref).abs().max())
    excess = float(((got - ref).abs() - RTOL * ref.abs()).max())
    check(excess <= ATOL, f"headline source 0 vs float64: max abs err {err}")
    sec = statistics.median(times)
    rate = audio.shape[0] * audio.shape[1] / SR / sec
    print(f"headline: {audio.shape[0]} src x {audio.shape[1] / SR:.0f} s "
          f"render {sec * 1e3:.3f} ms (median of {len(times)}: "
          f"{[round(s * 1e3, 3) for s in times]}) = {rate:.1f} audio-s/s; "
          f"source 0 vs float64 CPU max abs err {err:.3g} "
          f"(rtol {RTOL}, atol {ATOL}), max |ref| {float(ref.abs().max()):.3g}",
          flush=True)


def phase_mixture(device, mix, cfg):
    import torch

    from sonicsim_tpu_torch.bridge import to_torch
    from sonicsim_tpu_torch.ops import integrated_loudness
    from sonicsim_tpu_torch.parallel import render_mixture_sources

    up = to_torch({k: mix[k] for k in ("speech", "banks", "static_audio",
                                       "static_rirs", "weights")}, device)

    def step(weights):
        return render_mixture_sources(
            up["speech"], up["banks"], weights, mix["offsets"],
            mix["lengths"], mix["max_seg"], up["static_audio"],
            up["static_rirs"], mix["speech_lufs"], mix["static_lufs"], SR,
            device=device,
        )

    results, secs = {}, {}
    for form, weights in (("fused", None), ("weights", up["weights"])):
        results[form] = step(weights)  # warm-up
        sync(device)
        times = []
        for _ in range(cfg["iters"]):
            t0 = time.perf_counter()
            results[form] = step(weights)
            sync(device)
            times.append(time.perf_counter() - t0)
        secs[form] = statistics.median(times)
    targets = list(cfg["speech_lufs"]) + list(cfg["static_lufs"])
    lu = {}
    for form, (moving, static) in results.items():
        tracks = torch.cat([moving, static])
        check(bool(torch.isfinite(tracks).all()), f"{form}: output not finite")
        lu[form] = [float(integrated_loudness(x, SR)) for x in tracks]
        for got, want in zip(lu[form], targets):
            check(abs(got - want) <= LUFS_TOL,
                  f"{form}: track at {got:.4f} LUFS, target {want}")
    diff = max(float((a - b).abs().max())
               for a, b in zip(results["fused"], results["weights"]))
    check(diff <= FORMS_ATOL, f"fused vs weights= forms differ by {diff}")
    print(f"mixture: 3 speakers + 2 static, {cfg['duration']:.0f} s, "
          f"C={mix['banks'].shape[2]}, P={mix['banks'].shape[1]}: fused "
          f"{secs['fused']:.4f} s/mixture, weights= {secs['weights']:.4f} "
          f"s/mixture; LUFS fused {[round(v, 4) for v in lu['fused']]} "
          f"weights= {[round(v, 4) for v in lu['weights']]} (targets "
          f"{targets}, tol {LUFS_TOL} LU); forms max abs diff {diff:.3g}",
          flush=True)


def run(device, smi, head_cfg=HEADLINE, mix_cfg=MIXTURE) -> None:
    from sonicsim_tpu_torch.ops import kernels

    head = headline_plan(head_cfg)
    mix = mixture_inputs(mix_cfg)
    times = phase_kernels(device, head, mix)

    # The main path: every launch counted from here to the read below.
    kernels.reset_launch_counts()
    phase_headline(device, head, head_cfg)
    k1_headline = kernels.LAUNCHES["select_segments"]
    phase_mixture(device, mix, mix_cfg)
    launches = dict(kernels.LAUNCHES)
    if device.type == "cuda":
        check(k1_headline > 0, "select_segments: no launch in the headline render")
        check(launches["select_segments"] > k1_headline,
              "select_segments: no launch in the mixture step")
        check(launches["crossfade_combine"] > 0,
              "crossfade_combine: no launch in the mixture step")
    print(f"launches on the main path: {launches} (select_segments "
          f"{k1_headline} in the headline render)", flush=True)

    report = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": "sonicsim_tpu_torch/csrc/segment_select.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(times[c][name][2] for c in times),
            "ms": times["headline"][name][0],
            "plain_ms": times["headline"][name][1],
        }
        for name in ("select_segments", "crossfade_combine")
    ]}
    print(json.dumps(report), flush=True)
    print(smi, flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not importable", file=sys.stderr)
        return 1
    try:
        device, smi = phase_env()
        phase_build()
        run(device, smi)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    except ImportError as e:
        print(f"FAIL: {e} (run from the repository root)", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
