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
   times (CUDA events, median of 20), bytes moved and share of the
   memory-bandwidth bound. K1 runs in both forms; the ramp form reads
   strided views of (B, N, C, nfft) irfft-shaped tensors in place, and at
   the headline shapes it is timed against the separate epilogue it
   replaced (ramp tensor, multiply, add, then the select form);
4. the headline render (12 sources x 60 s x 40 binaural 16,000-tap RIRs,
   the workload of ``bench.py``) through ``convolve_moving_segmented``,
   one source checked against the plain path in float64 on the CPU, with
   the peak device memory of one render;
5. the mixture step (3 moving speakers + noise + music, 60 s, binaural)
   through ``render_mixture_sources`` in its fused and ``weights=`` forms,
   checked for finiteness, target loudness and agreement.

Then a JSON line of the kernels' numbers, the card's name and power limit as
``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero with no
result, as does a run with no CUDA device or outside the repository.

``python3 chip_smoke.py --profile [--port-root DIR]`` instead profiles the
main path (``torch.profiler``): wall and device-busy time per call, kernels
per call, the top kernels and the peak device memory, of the headline render
and the fused mixture step. ``--port-root`` measures the port found under
another checkout, so two commits compare in one run on one card.
"""

from __future__ import annotations

import argparse
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
RAMP_ATOL = 1e-6  # expected 0: each op rounded as in the plain version
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
SOURCE = "sonicsim_tpu_torch/csrc/segment_select.cu"
REPLACES = {
    "select_segments": "sonicsim_tpu/ops/pallas_kernels.py:140",
    "select_segments_ramp": "sonicsim_tpu/ops/pallas_kernels.py:140",
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


def _window_nfft(span: int, l: int) -> int:
    """The render's FFT size for windows of ``span`` outputs and ``l`` taps
    (fftconv.convolve_moving_segmented / _blocked)."""
    from sonicsim_tpu_torch.ops import next_fast_len

    return next_fast_len(-(-(span + l - 1) // 128) * 128)


def _kernel_bytes(name: str, bsz: int, n: int, c: int, t: int) -> int:
    """Bytes the function must move: each output sample written once, the
    one (select form) or two (ramp form, K2) window values it needs read
    once, K2's per-sample weight, and the (B, N) tables."""
    reads, per_sample, tables = {
        "select_segments": (1, 0, 2),
        "select_segments_ramp": (2, 0, 4),
        "crossfade_combine": (2, 1, 2),
    }[name]
    return 4 * (bsz * c * t * (1 + reads) + bsz * t * per_sample + bsz * n * tables)


def _kernel_case(device, tables, lengths, shift, span, nfft, lead, c, t, w, seed):
    """Random K1/K2 operands on ``device`` for (B, N) tables: contiguous
    windows for the select form and K2, and for the ramp form (B, N, C, nfft)
    tensors sliced at ``lead`` (the overlap-save offset l − 1), as the
    render lays out its irfft outputs."""
    import torch

    off = torch.as_tensor(tables, device=device, dtype=torch.int32)
    off_al = off - off % 128
    bsz, n = off.shape
    g = torch.Generator(device=device).manual_seed(seed)
    full = torch.randn((2, bsz, n, c, nfft), generator=g, device=device)
    le = torch.as_tensor(lengths, device=device).to(torch.float32)
    return dict(
        off=off, off_al=off_al,
        combined=torch.randn((bsz, n, c, span), generator=g, device=device),
        conv=torch.randn((bsz, n, 2, c, span), generator=g, device=device),
        wt=torch.as_tensor(w, device=device, dtype=torch.float32).expand(bsz, t).contiguous(),
        conv_s=full[0][..., lead:lead + span], conv_d=full[1][..., lead:lead + span],
        shift=torch.as_tensor(shift, device=device, dtype=torch.float32),
        scale=1.0 / torch.clamp(le, min=1.0),
    )


def _ab_epilogue(device, k, t):
    """The headline A/B: the separate epilogue the ramp form replaced (ramp
    tensor (u − lead)/len, multiply, add, then K1's select form) against
    the ramp form, on the same strided operands. Returns (separate ms, ramp
    ms, max abs diff)."""
    import torch

    from sonicsim_tpu_torch.ops import kernels

    span = k["conv_s"].shape[-1]
    u = torch.arange(span, device=device, dtype=torch.float32)
    lead = (k["off"] - k["off_al"]).to(torch.float32)[..., None]
    inv_len = k["scale"][..., None]

    def separate():
        ramp = (u - lead) * inv_len
        combined = k["conv_s"] + ramp[:, :, None, :] * k["conv_d"]
        return kernels.select_segments(combined, k["off"], k["off_al"], t)

    def fused():
        return kernels.select_segments(k["conv_s"], k["off"], k["off_al"], t,
                                       k["conv_d"], k["shift"], k["scale"])

    diff = float((separate() - fused()).abs().max())
    # In turns: separate, fused, fused, separate.
    ms_sep = [median_ms(separate, device)]
    ms_fused = [median_ms(fused, device), median_ms(fused, device)]
    ms_sep.append(median_ms(separate, device))
    return statistics.mean(ms_sep), statistics.mean(ms_fused), diff


def _yardsticks(device, bsz: int, c: int, t: int) -> tuple[float, float]:
    """What the card streams for the same bytes as K1's two forms, with no
    select: ``torch.add`` of two (B, C, T) tensors (the ramp form's 2 reads
    and 1 write) and ``copy_`` of one (the select form's). In ms."""
    import torch

    a = torch.randn((bsz, c, t), device=device)
    b = torch.randn((bsz, c, t), device=device)
    o = torch.empty_like(a)
    return (median_ms(lambda: torch.add(a, b, out=o), device),
            median_ms(lambda: o.copy_(a), device))


def phase_kernels(device, head, mix):
    """Each kernel against its plain version on the card, at the headline
    shapes and the blocked path's short-segment shapes."""
    from sonicsim_tpu_torch.ops import block_plan_sizes, kernels, moving_block_plan

    audio, rirs, w, offsets, lengths, max_seg = head
    n_src, t = audio.shape
    c, l_head = rirs.shape[2], rirs.shape[3]
    span = max_seg + 128
    off_al = offsets - offsets % 128
    cases = {"headline": (np.tile(offsets, (n_src, 1)), np.tile(lengths, (n_src, 1)),
                          np.tile(off_al - offsets, (n_src, 1)), span,
                          _window_nfft(span, l_head), l_head - 1, w)}
    block, nb = block_plan_sizes(mix["max_seg"], t, mix["offsets"].shape[1])
    plans = [moving_block_plan(o, le, t, block, nb)
             for o, le in zip(mix["offsets"], mix["lengths"])]
    boff = np.stack([p[0] for p in plans])
    bseg = np.stack([p[1] for p in plans])
    d = np.diff(boff, axis=1)
    check(int(d[d > 0].min()) < 8192,
          "the blocked case has no block shorter than 8192")
    so = np.take_along_axis(mix["offsets"], bseg, 1)
    l_mix = mix["banks"].shape[-1]
    cases["short"] = (boff, np.take_along_axis(mix["lengths"], bseg, 1),
                      (boff - boff % 128) - so, block + 128,
                      _window_nfft(block + 128, l_mix), l_mix - 1,
                      mix["weights"][0])
    results, ab = {}, None
    for seed, (name, (tables, lens, shift, span, nfft, lead, wc)) in enumerate(cases.items()):
        k = _kernel_case(device, tables, lens, shift, span, nfft, lead, c, t, wc, seed)
        off, off_al = k["off"], k["off_al"]
        ramp_args = (k["conv_s"], off, off_al, t, k["conv_d"], k["shift"], k["scale"])
        runs = {
            "select_segments": (
                lambda: kernels.select_segments(k["combined"], off, off_al, t),
                lambda: kernels.select_segments_ref(k["combined"], off, off_al, t),
                0.0),
            "select_segments_ramp": (
                lambda: kernels.select_segments(*ramp_args),
                lambda: kernels.select_segments_ref(*ramp_args),
                RAMP_ATOL),
            "crossfade_combine": (
                lambda: kernels.crossfade_combine(k["conv"], k["wt"], off, off_al, t),
                lambda: kernels.crossfade_combine_ref(k["conv"], k["wt"], off, off_al, t),
                K2_ATOL),
        }
        res = {}
        for kname, (kern, plain, tol) in runs.items():
            err = float((kern() - plain()).abs().max())
            sync(device)
            check(err <= tol, f"{kname} differs from plain ({name}): {err} > {tol}")
            nbytes = _kernel_bytes(kname, off.shape[0], off.shape[1], c, t)
            res[kname] = dict(ms=median_ms(kern, device),
                              plain_ms=median_ms(plain, device), err=err,
                              bytes=nbytes,
                              bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        results[name] = res
        print(f"kernels[{name}]: B={off.shape[0]} N={off.shape[1]} C={c} "
              f"span={span} T={t} (ramp operands: rows of nfft={nfft} at "
              f"offset {lead}) | "
              + " | ".join(
                  f"{kn} {v['ms']:.4f} ms vs plain {v['plain_ms']:.4f} ms, "
                  f"max abs err {v['err']:.3g}, {v['bytes'] / 1e6:.1f} MB, "
                  f"bound {v['bound_ms']:.4f} ms = "
                  f"{v['bound_ms'] / v['ms']:.1%} of 3.35 TB/s"
                  for kn, v in res.items()),
              flush=True)
        if name == "headline":
            ab = _ab_epilogue(device, k, t)
            check(ab[2] == 0.0, f"ramp form differs from the separate epilogue: {ab[2]}")
            check(device.type != "cuda" or ab[1] < ab[0],
                  f"ramp form {ab[1]:.4f} ms not faster than the separate "
                  f"epilogue {ab[0]:.4f} ms")
            print(f"kernels[headline] A/B: separate epilogue (ramp tensor, "
                  f"multiply, add, select form) {ab[0]:.4f} ms vs ramp form "
                  f"{ab[1]:.4f} ms (mean of two medians of 20 each, in turns), "
                  f"max abs diff {ab[2]:.3g}", flush=True)
            add_ms, copy_ms = _yardsticks(device, off.shape[0], c, t)
            print(f"kernels[headline] yardsticks, same bytes and no select: "
                  f"torch.add {add_ms:.4f} ms (ramp form's), copy_ "
                  f"{copy_ms:.4f} ms (select form's)", flush=True)
        del k
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
    peak_mib = None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        render()
        sync(device)
        peak_mib = (torch.cuda.max_memory_allocated(device) - base) / 2**20
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
          f"(rtol {RTOL}, atol {ATOL}), max |ref| {float(ref.abs().max()):.3g}; "
          f"peak extra device memory of one render {peak_mib} MiB",
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
    ramp_headline = kernels.LAUNCHES["select_segments_ramp"]
    phase_mixture(device, mix, mix_cfg)
    launches = dict(kernels.LAUNCHES)
    if device.type == "cuda":
        check(ramp_headline > 0,
              "select_segments (ramp form): no launch in the headline render")
        check(launches["select_segments_ramp"] > ramp_headline,
              "select_segments (ramp form): no launch in the mixture step")
        check(launches["crossfade_combine"] > 0,
              "crossfade_combine: no launch in the mixture step")
    print(f"launches on the main path: {launches} (ramp form "
          f"{ramp_headline} in the headline render; the select form is no "
          f"longer on the main path)", flush=True)

    report = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(times[c][name]["err"] for c in times),
            "ms": times["headline"][name]["ms"],
            "plain_ms": times["headline"][name]["plain_ms"],
            "bytes": times["headline"][name]["bytes"],
            "bound_ms": times["headline"][name]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,  # no single PyTorch call computes it
        }
        for name in ("select_segments", "select_segments_ramp", "crossfade_combine")
    ]}
    print(json.dumps(report), flush=True)
    print(smi, flush=True)


def _device_intervals(prof):
    """(start, end, name) in µs of every kernel, copy and fill on the card."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)


def _busy_us(intervals) -> float:
    """Length of the union of the intervals."""
    busy, end = 0.0, float("-inf")
    for a, b, _ in intervals:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def phase_profile(device, head_cfg=HEADLINE, mix_cfg=MIXTURE, reps: int = 10):
    """The main path under ``torch.profiler``: for the headline render and
    the fused mixture step, ``reps`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import sonicsim_tpu_torch
    from sonicsim_tpu_torch.bridge import to_torch
    from sonicsim_tpu_torch.ops import convolve_moving_segmented
    from sonicsim_tpu_torch.parallel import render_mixture_sources

    audio, rirs, _, offsets, lengths, max_seg = headline_plan(head_cfg)
    x, r = to_torch((audio, rirs), device)
    mix = mixture_inputs(mix_cfg)
    up = to_torch({k: mix[k] for k in ("speech", "banks", "static_audio",
                                       "static_rirs")}, device)
    paths = {
        "headline": lambda: convolve_moving_segmented(
            x, r, None, offsets, lengths, max_seg),
        "mixture": lambda: render_mixture_sources(
            up["speech"], up["banks"], None, mix["offsets"], mix["lengths"],
            mix["max_seg"], up["static_audio"], up["static_rirs"],
            mix["speech_lufs"], mix["static_lufs"], SR, device=device),
    }
    report = {"port": sonicsim_tpu_torch.__file__}
    for name, fn in paths.items():
        fn()
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        fn()
        sync(device)
        peak_mib = (torch.cuda.max_memory_allocated(device) - base) / 2**20
        walls = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                sync(device)
                walls.append((time.perf_counter() - t0) * 1e3)
        iv = _device_intervals(prof)
        check(bool(iv), f"profile[{name}]: no device activity in the trace")
        by_name: dict[str, list] = {}
        for a, b, kname in iv:
            by_name.setdefault(kname, []).append(b - a)
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
        wall_ms = sum(walls) / reps
        busy_ms = _busy_us(iv) / 1e3 / reps
        report[name] = dict(
            wall_ms=wall_ms, wall_median_ms=statistics.median(walls),
            device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
            kernels_per_call=len(iv) / reps, peak_extra_mib=peak_mib,
            top=[(k[:90], sum(v) / 1e3 / reps, len(v) / reps) for k, v in top],
        )
        print(f"profile[{name}]: wall {wall_ms:.4f} ms/call (median "
              f"{statistics.median(walls):.4f}), device busy {busy_ms:.4f} "
              f"ms/call = {busy_ms / wall_ms:.1%}, {len(iv) / reps:.0f} device "
              f"ops/call, peak extra memory {peak_mib:.1f} MiB", flush=True)
        for k, v, cnt in report[name]["top"]:
            print(f"  {v:.4f} ms/call x{cnt:g}  {k}", flush=True)
    print(json.dumps({"profile": report}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile the main path instead of the smoke phases")
    ap.add_argument("--port-root", default=None,
                    help="import sonicsim_tpu_torch from this checkout")
    args = ap.parse_args()
    if args.port_root:
        sys.path.insert(0, args.port_root)
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not importable", file=sys.stderr)
        return 1
    try:
        device, smi = phase_env()
        phase_build()
        if args.profile:
            phase_profile(device)
            print(smi, flush=True)
        else:
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
