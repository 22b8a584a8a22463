#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

From the repository root, on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, one line each:

1. environment (torch, CUDA, triton, nvcc, the card);
2. build of the Hopper kernels from ``sonicsim_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   headline shapes, at the blocked path's short-segment shapes and at the
   shapes bank -> mixture (phase 7) gives it, with
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
   checked for finiteness, target loudness and agreement;
6. the RIR-bank render at ``bench_all.py``'s shapes (3 banks x 40
   waypoints, one binaural receiver, 32 bands, order 4: 240 items of 5,832
   images, 6,355 taps) through ``render_rir_banks``: shape, finiteness, a
   peak of 1 per bank, bit-identical repeats, 8 items against the same
   function on the CPU, IR audio-seconds per second over 5 calls with the
   host included, the peak device memory, and a second room with banded
   per-wall materials (rank r > 1 and Q > 1);
7. bank -> mixture: phase 6's banks as the moving banks, and a 2-source
   static bank, through both forms of the mixture step without leaving
   the device, under phase 5's gates.

Then a JSON line of the kernels' numbers, the card's name and power limit as
``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero with no
result, as does a run with no CUDA device or outside the repository.

``python3 chip_smoke.py --profile [--port-root DIR]`` instead profiles the
main path (``torch.profiler``): wall and device-busy time per call, device
ops per call, the top device ops and the peak device memory, of the headline
render, the fused mixture step and the RIR-bank render (with the share of
its device time in the placement product, ``aten::bmm``). ``--port-root`` measures the port found under
another checkout, so two commits compare in one run on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
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
# The RIR-bank render at bench_all.py's shapes (bench_all.py:308-367).
BANK = dict(dims=(8.0, 3.0, 6.0), absorption=0.3, n_bands=32, max_order=4,
            n_banks=3, n_ways=40, receiver=(4.0, 1.5, 3.0), iters=5, n_check=4)
BANK_MIXTURE = dict(duration=60.0, iters=3, speech_lufs=(-17.0, -17.0, -17.0),
                    static_lufs=(-24.0, -29.0))
# The bank on the card vs the same port function on the CPU: the JAX
# package's bank-vs-serial tolerance (tests/test_bank_render.py:51).
BANK_ATOL, BANK_RTOL = 5e-5, 1e-3  # atol is a fraction of the peak
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


def _blocked_case(offsets, lengths, max_seg, t, c, l, weights):
    """K1/K2 tables of ``render_mixture_sources``' blocked path for padded
    segment plans (S, P−1), ``l``-tap banks and (S, T) weights, as
    ``_kernel_case``'s case tuple."""
    from sonicsim_tpu_torch.ops import block_plan_sizes, moving_block_plan

    block, nb = block_plan_sizes(max_seg, t, offsets.shape[1])
    plans = [moving_block_plan(o, le, t, block, nb) for o, le in zip(offsets, lengths)]
    boff = np.stack([p[0] for p in plans])
    bseg = np.stack([p[1] for p in plans])
    so = np.take_along_axis(offsets, bseg, 1)
    return (boff, np.take_along_axis(lengths, bseg, 1), (boff - boff % 128) - so,
            block + 128, _window_nfft(block + 128, l), l - 1, c, weights)


def phase_kernels(device, head, mix, bank_cfg, bank_mix_cfg):
    """Each kernel against its plain version on the card, at the headline
    shapes, the blocked path's short-segment shapes, and the shapes bank ->
    mixture (phase 7) gives it: the rendered banks' ``ir_len`` and the
    block plans of phase 7's trajectories."""
    from sonicsim_tpu_torch.ops import kernels
    from sonicsim_tpu_torch.parallel import pad_moving_plans
    from sonicsim_tpu_torch.sim import bank_render

    audio, rirs, w, offsets, lengths, max_seg = head
    n_src, t = audio.shape
    c, l_head = rirs.shape[2], rirs.shape[3]
    span = max_seg + 128
    off_al = offsets - offsets % 128
    cases = {"headline": (np.tile(offsets, (n_src, 1)), np.tile(lengths, (n_src, 1)),
                          np.tile(off_al - offsets, (n_src, 1)), span,
                          _window_nfft(span, l_head), l_head - 1, c, w)}
    cases["short"] = _blocked_case(mix["offsets"], mix["lengths"], mix["max_seg"], t,
                                   mix["banks"].shape[2], mix["banks"].shape[-1],
                                   mix["weights"])
    d = np.diff(cases["short"][0], axis=1)
    check(int(d[d > 0].min()) < 8192,
          "the blocked case has no block shorter than 8192")
    # Phase 7's plans: its trajectories are deterministic, so phase 6 need
    # not run first; the tables do not depend on the banks' values.
    oracle, channel = bank_scene(bank_cfg, device=device)
    t_bank = int(SR * bank_mix_cfg["duration"])
    ways = [bank_ways(k, bank_cfg["n_ways"]) for k in range(bank_cfg["n_banks"])]
    weights, offs, lens = bank_mixture_plans(ways, t_bank)
    _, w_p, off_p, len_p, seg_max = pad_moving_plans(
        [np.zeros((len(wy), 1, 1), np.float32) for wy in ways], weights, offs, lens)
    cases["bank"] = _blocked_case(off_p, len_p, seg_max, t_bank, channel.count,
                                  bank_render._bank_params(oracle).ir_len, w_p)
    results, ab = {}, None
    for seed, (name, case) in enumerate(cases.items()):
        tables, lens, shift, span, nfft, lead, c, wc = case
        t = wc.shape[-1]
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


def _mixture_forms(device, step, targets, iters):
    """Both forms of the mixture step (``step(weights_form)``), timed after a
    warm-up and gated: finite, every track within LUFS_TOL of its target,
    the forms within FORMS_ATOL. Returns (s/mixture per form, LUFS per form,
    the forms' max abs diff)."""
    import torch

    from sonicsim_tpu_torch.ops import integrated_loudness

    results, secs = {}, {}
    for form in ("fused", "weights"):
        results[form] = step(form == "weights")  # warm-up
        sync(device)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            results[form] = step(form == "weights")
            sync(device)
            times.append(time.perf_counter() - t0)
        secs[form] = statistics.median(times)
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
    return secs, lu, diff


def phase_mixture(device, mix, cfg):
    from sonicsim_tpu_torch.bridge import to_torch
    from sonicsim_tpu_torch.parallel import render_mixture_sources

    up = to_torch({k: mix[k] for k in ("speech", "banks", "static_audio",
                                       "static_rirs", "weights")}, device)

    def step(weights_form):
        return render_mixture_sources(
            up["speech"], up["banks"], up["weights"] if weights_form else None,
            mix["offsets"], mix["lengths"], mix["max_seg"], up["static_audio"],
            up["static_rirs"], mix["speech_lufs"], mix["static_lufs"], SR,
            device=device,
        )

    targets = list(cfg["speech_lufs"]) + list(cfg["static_lufs"])
    secs, lu, diff = _mixture_forms(device, step, targets, cfg["iters"])
    print(f"mixture: 3 speakers + 2 static, {cfg['duration']:.0f} s, "
          f"C={mix['banks'].shape[2]}, P={mix['banks'].shape[1]}: fused "
          f"{secs['fused']:.4f} s/mixture, weights= {secs['weights']:.4f} "
          f"s/mixture; LUFS fused {[round(v, 4) for v in lu['fused']]} "
          f"weights= {[round(v, 4) for v in lu['weights']]} (targets "
          f"{targets}, tol {LUFS_TOL} LU); forms max abs diff {diff:.3g}",
          flush=True)


def bank_ways(k: int, n: int) -> list:
    """Waypoints of speaker bank ``k``: ``n`` positions drawn from
    ``default_rng(1000 + k)`` inside the room (bench_all.py:322-324)."""
    r = np.random.default_rng(1000 + k)
    return [r.uniform([1, 1, 1], [7, 2.5, 5]) for _ in range(n)]


def bank_scene(cfg, walls: bool = False, device=None):
    """The bench_all.py bank render's oracle, rendering on ``device``, and
    channel: an 8 x 3 x 6 m room at absorption 0.3, or (``walls``) the same
    room with banded per-wall materials (brick walls, carpet floor, tiled
    ceiling), whose amplitude profile has rank r > 1 and whose decay table
    has rank Q > 1."""
    from sonicsim_tpu_torch.sim import (
        ChannelModel,
        Material,
        ShoeboxRoom,
        SyntheticRirOracle,
        wall_curves_from_labels,
    )

    curves = {}
    if walls:
        materials = {
            "brick": Material("brick", [0.02, 0.03, 0.04, 0.05, 0.07],
                              [0.1, 0.2, 0.3, 0.4, 0.5]),
            "carpet": Material("carpet", [0.08, 0.24, 0.57, 0.69, 0.71],
                               [0.1, 0.1, 0.2, 0.3, 0.4]),
            "tile": Material("tile", [0.3, 0.2, 0.1, 0.08, 0.05],
                             [0.05, 0.05, 0.1, 0.1, 0.15], [0.05, 0.02, 0.01, 0.0, 0.0]),
        }
        curves = wall_curves_from_labels(
            {"floor": "carpet", "ceiling": "tile", "walls": "brick"},
            materials, n_bands=cfg["n_bands"], sample_rate=SR)
    room = ShoeboxRoom(cfg["dims"], absorption=cfg["absorption"], **curves)
    oracle = SyntheticRirOracle(room, sample_rate=SR, n_bands=cfg["n_bands"],
                                max_order=cfg["max_order"],
                                device=None if device is None else str(device))
    return oracle, ChannelModel("Binaural")


def _bank_vs_cpu(oracle, channel, srcs, mic):
    """The first sources' items rendered on the oracle's device and on the
    CPU by the same port function, un-normalised: (max abs err, peak, excess
    over BANK_ATOL·peak + BANK_RTOL·|cpu|)."""
    from sonicsim_tpu_torch.sim import render_bank_batched

    got = render_bank_batched(oracle, srcs, mic, channel, peak_normalize=False)
    ref = render_bank_batched(dataclasses.replace(oracle, device="cpu"), srcs, mic,
                              channel, peak_normalize=False)
    peak = float(np.abs(ref).max())
    err = np.abs(got - ref)
    excess = float((err - BANK_ATOL * peak - BANK_RTOL * np.abs(ref)).max())
    return float(err.max()), peak, excess


def phase_bank(device, cfg):
    """The RIR-bank render at bench_all.py's shapes: 3 banks x 40 waypoints,
    one binaural receiver, 32 bands, order 4. Returns the three banks and
    their waypoints, and a 2-source static bank, all on the device."""
    import torch

    from sonicsim_tpu_torch.sim import render_rir_banks

    oracle, channel = bank_scene(cfg, device=device)
    mic = [np.asarray(cfg["receiver"], np.float64)]
    n, nb = cfg["n_ways"], cfg["n_banks"]
    ways = [bank_ways(k, n) for k in range(nb)]

    def render(lists):
        return render_rir_banks(oracle, lists, mic, channel, out_device=True)

    # Warm-up (cuFFT plans) on geometry the timed calls do not use, as
    # bench_all.py does.
    render([bank_ways(90 + k, n) for k in range(nb)])
    sync(device)
    # Fresh geometry every call; host flatten and hashing included; one
    # trailing synchronise, as bench_all.py times it.
    t0 = time.perf_counter()
    audio_s = 0.0
    for it in range(cfg["iters"]):
        out = render([bank_ways(nb * it + i, n) for i in range(nb)])
        audio_s += sum(b.numel() / SR for b in out)
    sync(device)
    sec = time.perf_counter() - t0
    banks = render(ways)
    sync(device)
    peak_mib = None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        banks = render(ways)
        sync(device)
        peak_mib = (torch.cuda.max_memory_allocated(device) - base) / 2**20
    again = render(ways)
    sync(device)
    check(all(torch.equal(a, b) for a, b in zip(banks, again)),
          "two bank renders on the device differ")
    ir_len = banks[0].shape[-1]
    for b in banks:
        check(tuple(b.shape) == (n, 1, channel.count, ir_len),
              f"bank shape {tuple(b.shape)}")
        check(bool(torch.isfinite(b).all()), "bank not finite")
        check(abs(float(b.abs().max()) - 1.0) <= 1e-6, "bank peak is not 1")
    err, peak, excess = _bank_vs_cpu(oracle, channel, ways[0][:cfg["n_check"]], mic)
    check(excess <= 0.0, f"bank on the device vs the CPU: max abs err {err} "
          f"(peak {peak}, atol {BANK_ATOL}·peak, rtol {BANK_RTOL})")
    print(f"bank: {nb} banks x {n} waypoints x {channel.count} ch = "
          f"{nb * n * channel.count} items, {cfg['n_bands']} bands, order "
          f"{cfg['max_order']}, ir_len {ir_len}: {cfg['iters']} calls in "
          f"{sec:.4f} s = {sec / cfg['iters'] * 1e3:.3f} ms/call = "
          f"{audio_s / sec:.1f} IR audio-s/s ({audio_s / cfg['iters']:.3f} "
          f"audio-s per call); peaks 1, finite, repeat bit-identical; "
          f"{2 * cfg['n_check']} items vs the CPU: max abs err {err:.3g} of "
          f"peak {peak:.3g}; peak extra device memory of one render "
          f"{peak_mib} MiB", flush=True)

    w_oracle, w_channel = bank_scene(cfg, walls=True, device=device)
    from sonicsim_tpu_torch.sim import bank_render

    tables = bank_render._bank_params(w_oracle)
    r_amp, q_tail = tables.amp_u.shape[1], tables.tail_u.shape[1]
    check(r_amp > 1 and q_tail > 1, f"per-wall room has r={r_amp}, Q={q_tail}")
    w_bank = render_rir_banks(w_oracle, [ways[0]], mic, w_channel,
                              out_device=True)[0]
    check(bool(torch.isfinite(w_bank).all()), "per-wall bank not finite")
    check(abs(float(w_bank.abs().max()) - 1.0) <= 1e-6, "per-wall bank peak is not 1")
    w_err, w_peak, w_excess = _bank_vs_cpu(w_oracle, w_channel,
                                           ways[0][:cfg["n_check"]], mic)
    check(w_excess <= 0.0, f"per-wall bank on the device vs the CPU: max abs "
          f"err {w_err} (peak {w_peak})")
    print(f"bank[per-wall materials]: r={r_amp}, Q={q_tail}, ir_len "
          f"{w_bank.shape[-1]}, {n} waypoints finite with peak 1; "
          f"{2 * cfg['n_check']} items vs the CPU: max abs err {w_err:.3g} of "
          f"peak {w_peak:.3g}", flush=True)

    static = render_rir_banks(oracle, [bank_ways(100, 2)], mic, channel,
                              out_device=True)[0]
    return banks, ways, static


def bank_mixture_plans(ways, t: int):
    """Phase 7's crossfade plans: each bank's waypoints through
    ``dynamic_interp_plan`` (one ``default_rng(2)`` in turn) and
    ``segment_plan``. Returns (weights, offsets, lengths) lists."""
    from sonicsim_tpu_torch.ops import dynamic_interp_plan, segment_plan

    rng = np.random.default_rng(2)
    weights, offs, lens = [], [], []
    for w in ways:
        idx, wt = dynamic_interp_plan(np.asarray(w), t, rng=rng)
        o, le, _ = segment_plan(idx)
        weights.append(wt)
        offs.append(o)
        lens.append(le)
    return weights, offs, lens


def phase_bank_mixture(device, banks, ways, static, cfg):
    """Phase 6's banks as the moving banks of the mixture step, and its static
    bank as the static RIRs, without leaving the device."""
    import torch

    from sonicsim_tpu_torch.parallel import pad_moving_plans, render_mixture_sources

    t = int(SR * cfg["duration"])
    weights, offs, lens = bank_mixture_plans(ways, t)
    banks_p, w_p, off_p, len_p, max_seg = pad_moving_plans(
        [b[:, 0] for b in banks], weights, offs, lens)
    check(torch.is_tensor(banks_p) and banks_p.device == banks[0].device,
          "padded banks left the device")
    speech = torch.randn((len(banks), t), generator=torch.Generator(device=device).manual_seed(3),
                         device=device) * 0.1
    static_audio = torch.randn((2, t), generator=torch.Generator(device=device).manual_seed(4),
                               device=device) * 0.1
    w_dev = torch.as_tensor(w_p, device=device)

    def step(weights_form):
        return render_mixture_sources(
            speech, banks_p, w_dev if weights_form else None, off_p, len_p,
            max_seg, static_audio, static[:, 0], cfg["speech_lufs"],
            cfg["static_lufs"], SR)

    targets = list(cfg["speech_lufs"]) + list(cfg["static_lufs"])
    secs, lu, diff = _mixture_forms(device, step, targets, cfg["iters"])
    print(f"bank->mixture: {len(banks)} moving banks {tuple(banks_p.shape)} + "
          f"static {tuple(static[:, 0].shape)}, {cfg['duration']:.0f} s: fused "
          f"{secs['fused']:.4f} s/mixture, weights= {secs['weights']:.4f} "
          f"s/mixture; LUFS fused {[round(v, 4) for v in lu['fused']]} "
          f"weights= {[round(v, 4) for v in lu['weights']]} (targets "
          f"{targets}, tol {LUFS_TOL} LU); forms max abs diff {diff:.3g}",
          flush=True)


def run(device, smi, head_cfg=HEADLINE, mix_cfg=MIXTURE, bank_cfg=BANK,
        bank_mix_cfg=BANK_MIXTURE) -> None:
    from sonicsim_tpu_torch.ops import kernels

    head = headline_plan(head_cfg)
    mix = mixture_inputs(mix_cfg)
    times = phase_kernels(device, head, mix, bank_cfg, bank_mix_cfg)

    # The main paths: each one's launches counted from a reset just before
    # it to the read just after.
    counts = {}
    kernels.reset_launch_counts()
    phase_headline(device, head, head_cfg)
    counts["headline"] = dict(kernels.LAUNCHES)
    kernels.reset_launch_counts()
    phase_mixture(device, mix, mix_cfg)
    counts["mixture"] = dict(kernels.LAUNCHES)
    banks, ways, static = phase_bank(device, bank_cfg)
    kernels.reset_launch_counts()
    phase_bank_mixture(device, banks, ways, static, bank_mix_cfg)
    counts["bank->mixture"] = dict(kernels.LAUNCHES)
    launches = {k: sum(c[k] for c in counts.values()) for k in kernels.LAUNCHES}
    if device.type == "cuda":
        for path, c in counts.items():
            check(c["select_segments_ramp"] > 0,
                  f"select_segments (ramp form): no launch in {path}")
        for path in ("mixture", "bank->mixture"):
            check(counts[path]["crossfade_combine"] > 0,
                  f"crossfade_combine: no launch in {path}")
    print(f"launches on the main paths: {counts} (the select form is off "
          f"the main paths; the bank render has no kernel of its own)",
          flush=True)

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


def phase_profile(device, head_cfg=HEADLINE, mix_cfg=MIXTURE, bank_cfg=BANK,
                  reps: int = 10):
    """The main paths under ``torch.profiler``: for the headline render, the
    fused mixture step and the RIR-bank render, ``reps`` calls after a
    warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import sonicsim_tpu_torch
    from sonicsim_tpu_torch.bridge import to_torch
    from sonicsim_tpu_torch.ops import convolve_moving_segmented
    from sonicsim_tpu_torch.parallel import render_mixture_sources
    from sonicsim_tpu_torch.sim import render_rir_banks

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
    oracle, channel = bank_scene(bank_cfg, device=device)
    mic = [np.asarray(bank_cfg["receiver"], np.float64)]
    ways = [bank_ways(k, bank_cfg["n_ways"]) for k in range(bank_cfg["n_banks"])]
    paths["bank"] = lambda: render_rir_banks(oracle, ways, mic, channel,
                                             out_device=True)
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
        averages = prof.key_averages()
        bmm_ms = sum(e.device_time_total for e in averages
                     if e.key == "aten::bmm") / 1e3 / reps
        top_ops = sorted(((e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
                          for e in averages
                          if e.key.startswith("aten::") and e.self_device_time_total > 0),
                         key=lambda x: -x[1])[:12]
        report[name] = dict(
            wall_ms=wall_ms, wall_median_ms=statistics.median(walls),
            device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
            kernels_per_call=len(iv) / reps, peak_extra_mib=peak_mib,
            bmm_ms=bmm_ms, bmm_share=bmm_ms / busy_ms, top_ops=top_ops,
            top=[(k[:90], sum(v) / 1e3 / reps, len(v) / reps) for k, v in top],
        )
        print(f"profile[{name}]: wall {wall_ms:.4f} ms/call (median "
              f"{statistics.median(walls):.4f}), device busy {busy_ms:.4f} "
              f"ms/call = {busy_ms / wall_ms:.1%}, {len(iv) / reps:.0f} device "
              f"ops/call, peak extra memory {peak_mib:.1f} MiB, aten::bmm "
              f"{bmm_ms:.4f} ms/call = {bmm_ms / busy_ms:.1%} of device busy",
              flush=True)
        for k, v, cnt in report[name]["top"]:
            print(f"  {v:.4f} ms/call x{cnt:g}  {k}", flush=True)
        print(f"profile[{name}] by operator (self device time):", flush=True)
        for k, v, cnt in top_ops:
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
