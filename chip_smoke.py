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
   the device, under phase 5's gates;
8. generation end to end: a seeded synthetic corpus (6 speakers x 12
   utterances of 2-16 s, 8 noise clips of 1-10 s, 6 music clips of 20-30 s,
   PCM16 WAVs written here) through ``generate_split`` with the CLI's
   scene factory at SonicSet's widths (60 s, binaural, 32 bands, order 4;
   2 scenes = 4 mixtures; pipelined, utterance cache, pcm16), after a
   warm-up mixture in a third scene: a disk-sink run, a second disk-sink
   run into a fresh root, and a device-sink run. Gates: the artifacts and
   their shapes, every track's loudness read back within 0.1 LU of its
   target (0.05 LU for the device-sink tracks, on the device), cache hits
   in the second scene, the two disk runs byte-identical, and one mixture
   against the port on the CPU. Phase 3's ``generation`` case holds K1 at
   the first timed mixture's shapes;
9. ConvTasNet serving at the full width of configs/separation/convtasnet.yaml
   (3,491,505 parameters, seeded weights in the JAX package's flax layout,
   saved with ``save_model`` and loaded with ``from_pretrain`` on the card):
   float32 against the port on the CPU on a 4 s crop; the forward's
   throughput (CUDA-event medians, audio-s/s, peak extra memory) for one
   60 s mixture in fp32 and bf16 and 16 crops of 4 s in bf16, bf16 held
   to rel-L2 0.05 of fp32; the inference CLI (``scripts.inference``) on
   phase 8's first mixture in fp32 and bf16; the remix evaluation
   (``scripts.audio_test``'s loop) over phase 8's disk-sink split on the
   metadata spans, with the default columns and PESQ, its wall split into
   forward and tracker time and ``metrics.csv``'s avg/std rows; the tracker
   on the card against the CPU on one segment. Serving launches neither
   kernel;
10. ConvTasNet training at the same width from phase 9's seeded weights,
    with the config's Adam, clip and PIT neg-SNR loss: the train step's time
    (CUDA-event median of 10 after 3), audio-s/s and peak extra memory in
    fp32 and bf16 on B=8 x 4 s crops of phase 8's split; one fp32 step on
    B=2 x 1 s against the CPU (loss and the clipped gradients); bf16
    against fp32 over 6 steps on one batch (both losses fall, the first
    within the JAX package's bound); a 2-epoch fit over phase 8's split
    through the train CLI's path (8 samples of 4 s, batch 2, val on the
    split's fixed remix), resumed for a third epoch, its artifacts checked
    and its checkpoints read back by ``from_pretrain`` bit-equal to the
    trained model; seconds per epoch. Training launches neither kernel;
11. the separation zoo: DPRNN-TasNet, SuDORMRF, AFRCNN, TDANet, DPTNet,
    BSRNN, TF-GridNet, MossFormer, MossFormer2 and SkiM at the full width of
    their configs/separation/*.yaml, each built through the config's
    ``_target_`` with seeded weights in the JAX package's flax layout, saved
    with ``save_model`` and loaded with ``from_pretrain`` on the card: fp32
    against the port on the CPU on a 2 s crop of phase 8's first mixture;
    the forward's time on B=1 x 10 s (CUDA-event median of 3 after 1),
    audio-s/s and peak extra memory; the inference CLI on phase 8's first
    60 s mixture. The zoo launches neither kernel;
12. SkiM streaming: a causal SkiM at skim.yaml's widths (no segment
    overlap) from a pack on the card, ``SkiMStreamer`` over 10 s of phase
    8's first mixture in 500-sample (31.25 ms) chunks at depth 0 and 2 and
    over 4 mixtures at once: per-chunk latency (median, p95) and the
    real-time factor; the stream within rtol 1e-3 / atol 1e-4 of the
    offline causal forward on the card, ``stream(depth)`` within 1e-6 of
    ``step``; then ``python -m sonicsim_tpu_torch.scripts.stream`` on the
    pack. It launches neither kernel;
13. the enhancement zoo: the model of each configs/enhancement/*.yaml
    (Fullband, FullSubnet, FullSubNet+, Inter-SubNet, FastFullSubnet, DCCRN,
    FRCRN, BSRNN-ESPnet, SuDORMRF, GaGNet, G2Net, TaylorSENet) at full width
    with seeded weights through the bridge and a pack: forward and
    ``to_waveform`` in fp32 against the port on the CPU on a 4 s crop, the
    10 s forward's time, audio-s/s and peak extra memory; FullSubnet through
    the remix evaluation (``scripts.audio_test``'s loop, task enhancement)
    over phase 8's split. It launches neither kernel;
14. enhancement training: each of those twelve models with its config's
    loss and metric, Adam (lr 1e-3) and clip (5), in fp32 from phase 13's
    seeded weights: the train step's time (CUDA-event median of 3 after 1),
    audio-s/s and peak extra memory at the configs' B=2 x 4 s on phase 8's
    split, and one step on B=2 x 0.5 s against the same step on the CPU,
    each side on the device's branch at every kinked activation: the step in
    float64 on the device within F64_REL = 1e-9 · max|g64| of float64 on
    the CPU, and in float32 the loss within rel 1e-5 and the clipped
    gradients within max(1e-4, ILL_FACTOR = 2 times the CPU's own float32
    distance from its float64 step) · max|g| (``enh_step_check``); then a
    2-epoch ``train_from_config`` fit of fullsubnet.yaml over the split
    with a ``generate_fixed_eval --task enhancement`` val set
    (``target_names: [clean]``), resumed for a third, its best checkpoint
    read back by ``from_pretrain``. It launches neither kernel;
15. separation training: the model of each configs/separation/*.yaml but
    convtasnet.yaml (phase 10) at full width from phase 11's seeded
    weights, with its config's optimizer (DPTNet's weight decay: AdamW),
    clip 5 and PIT neg-SNR, fp32: the train step's time (CUDA-event median
    of 3 after 1), audio-s/s and peak extra memory at the configs' B=2 x
    4 s on phase 8's split, and one step on B=2 x 0.5 s held to the CPU
    by ``enh_step_check``, phase 14's rule and window. It launches neither
    kernel;
16. the evaluation sidecars, on seeded stand-in graphs (no published
    weights are in the repository) written as .onnx files by
    ``onnx_bytes`` and read back by the port's ONNX executor: DNSMOS's
    two graphs at its shapes (the raw 9.01 s clip of phase 8's first
    mixture, and ``audio_melspec`` of it) through ``DNSMOS`` and
    ``make_dnsmos``, a SigMOS-shaped graph over its 48 kHz features through
    ``SigMOS`` and ``make_sigmos_all``, each graph on the card within 1e-4
    · max|ref| of the CPU with TF32 off and its ms per clip;
    ``wav_chunk_inference`` of SuDORMRF at full width over 20 s against the
    CPU; the composite measures' (CSIG/CBAK/COVL) host seconds per 60 s
    mixture beside PESQ's and STOI's. It launches neither kernel;
17. the sidecar models at their published widths, seeded weights written
    in each checkpoint's own format (no published weights are in the
    repository): Whisper medium.en (769 M parameters, an HF directory)
    through ``make_whisper_asr`` on one 30 s window of phase 8's first
    mixture, greedy and beam 5 with the temperature fallback (ms per
    window and per decoded token, peak memory), its log-mel, encoder
    output and teacher-forced logits of 32 positions within 1e-4 ·
    max|ref| of the CPU and its greedy tokens the CPU's argmax up to the
    first near-tie; ECAPA-TDNN at spkrec-ecapa-voxceleb's widths on 10 s of
    each speech track (1e-4 · max|ref|, cosine ≥ 1 − 1e-6) and
    ``inference --ecapa`` with phase 9's pack; PyanNet at the JAX module's
    defaults on the 60 s mixture (frame probabilities within 1e-4, spans
    the CPU's but at frames that near the threshold) and ``test --vad_ckpt
    --whisper --limit 1`` over phase 8's split, its ``asr`` column's host
    seconds beside PESQ's and STOI's. It launches neither kernel;
18. the model variants no config takes, each at its config's full width
    with the flag flipped: DCCRN(use_clstm=False), Fullband, FullSubnet,
    FastFullSubnet and FullSubNet+ with sequence_model="GRU", and
    GaGNet(is_u2=False), seeded weights through the bridge and a pack:
    phase 13's forward checks on a 2 s crop and its B=1 x 10 s timing, bf16
    where ``require_bf16`` allows the variant (else its refusal), the
    config's train step at B=2 x 4 s and one step held to the CPU by
    ``enh_step_check`` (phase 14's rule). It launches neither kernel;
19. (a) every name of the optimizer zoo (``make_optimizer``, optax's 14)
    over DPTNet's full-width parameters at 2 of its 6 layers: three steps of seeded float64
    gradients, the card in float64 within 1e-9 · max|Δp64| of the CPU, in
    float32 by phase 10's rule, each step's time; (b) a two-epoch
    ``Trainer.fit`` of enhancement SuDORMRF with lamb on
    ``RemixTrainDataset`` items from phase 8's split, its stages timed by
    ``StageTimer``; neither launches a kernel. (c) phase 6's banks as a
    reference ``rir_save_*.pt`` through ``scripts.import_rir_banks`` and
    ``BankRirOracle`` into phase 7's mixture step, bit-equal to phase 7's
    (phase 7's path: both kernels launch).
20. the device mesh (``parallel.mesh``): two replicas of the card, and
    ``make_mesh()`` where the host has more cards; each sharded call held
    to the unsharded call on the card and both timed: (a)
    ``render_mixture_sources(mesh=)`` at the headline's shapes (12 sources
    x 60 s, 40 binaural 16,000-tap RIRs, 2 static sources), fused and
    ``weights=``, within 1e-6; (b) phase 6's banks through
    ``render_rir_banks(mesh=)``, a bank across the shards, within 1e-6,
    peak 1 per bank; (c) phase 8's first mixture through
    ``render_mixture(mesh=)``, both sinks, within one int16 step; (d)
    ``wav_chunk_inference(mesh=)`` of a 60 s mixture with ConvTasNet and
    DCCRN at their configs' widths, within 1e-5 · max|ref| of the unsharded
    call at ``batch_size`` x 2 (DCCRN's batch statistics over every window
    of a call); (e) the data-parallel train step (ConvTasNet at B=8 x 4 s,
    DCCRN and FRCRN at B=2 x 4 s): float64 within 1e-9 · max|g64| of the
    unsharded step, float32 within max(1e-4, 2 x the unsharded float32
    step's largest distance over three roundings: the batch in order,
    reversed, each item twice) · max|g64| of the unsharded float64 step
    (phase 14's rule), ms/step sharded and unsharded. (a)-(c) are a main path: K1's
    ramp form and K2 launch there;
21. the checkpoint import and optax's keywords: (a) seeded reference
    checkpoints (``.pth``, the reference's parameter names) of ConvTasNet,
    TDANet, DCCRN and FRCRN at their configs' widths through ``python -m
    sonicsim_tpu_torch.scripts.import_checkpoint`` (seconds per
    conversion), each pack and its ``.pth`` loaded by ``from_pretrain`` on
    the card with the same weights bit for bit, and the two forwards of a
    2 s crop of phase 8's first mixture (cuDNN's deterministic algorithms)
    within 1e-4 · max|ref|; (b) one case per optax keyword the port once
    took at its default only (masks as callables on the flax tree, moments
    in bfloat16) by phase 19 (a)'s rule; (c) the bf16 LSTM and GRU layers
    (flax's rounded input projection fed through an identity input weight)
    at the configs' widths, uni- and bidirectional, one and two layers: the
    card against the CPU within rel-L2 1e-4, and each layer's bf16 and fp32
    forward times.

Phase 6 also prints, for the source of the bank's largest error against
the CPU, where the two sides' renders part op by op, the image delays
near that error, and each side's distance from the same items rendered in
float64 on the CPU (ROADMAP C9); ``--trace-dir DIR`` writes the whole trace
to ``DIR/c9_*.json``. Phase 1's line is printed again before phase 6.

Then a JSON line of the kernels' numbers, the card's name and power limit as
``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero with no
result, as does a run with no CUDA device or outside the repository.

``python3 chip_smoke.py --profile [--port-root DIR]`` instead profiles the
main path (``torch.profiler``): wall and device-busy time per call, device
ops per call, the top device ops and the peak device memory, of the headline
render, the fused mixture step, the RIR-bank render (with the share of
its device time in the placement product, ``aten::bmm``), one generated
60 s mixture with the disk sink and one with the device sink,
ConvTasNet's forward (``serve-fp32-60s``, ``serve-bf16-B16``) and its
train step (``train-fp32-B8``, ``train-bf16-B8``; ``train-optim-…`` with
the port's optax-form Adam), each zoo model's
10 s forward (``zoo-<name>-10s``, and ``zoo-<name>-10s-bf16`` where the
port serves it in bf16), each enhancement model's (``enh-<config>-10s``,
``…-bf16``) and each separation config's train step at B=2 x 4 s
(``sep-train-<config>``); ``--only PREFIX`` builds and profiles the
paths whose name starts with PREFIX alone (several, comma-separated).
``--port-root`` measures the port found under another checkout, so two
commits compare in one run on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import logging
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
C9_WINDOW, C9_PRINT = 128, 48  # samples around the bank's largest error; rows printed
RAMP_ATOL = 1e-6  # expected 0: each op rounded as in the plain version
# Generation end to end (phase 8): SonicSet's widths, a synthetic corpus of
# LibriSpeech-, FSD50K- and FMA-like lengths.
GENERATION = dict(duration=60.0, channel="Binaural", n_bands=32, max_order=4,
                  speakers=6, utterances=12, utt_s=(2.0, 16.0), noise=8,
                  noise_s=(1.0, 10.0), music=6, music_s=(20.0, 30.0),
                  scenes=("scene000", "scene001"), warm_scene="scene900", seed=0)
GEN_LU_TOL = 0.1  # tracks read back from PCM16 WAVs
SLICE_REL = 4e-5  # tests/test_torch_slice.py: tracks through rendered banks
# Phase 9: ConvTasNet serving at the full width of the model node of
# configs/separation/convtasnet.yaml, written out here because the card's
# host may have no pyyaml; seeded weights.
SERVE = dict(model=dict(N=512, L=32, B=128, H=512, P=3, X=8, R=3, norm="gLN",
                        num_spks=2, activate="relu", causal=False, sample_rate=SR),
             params=3_491_505, seed=0, crop_s=4.0, batch=16, segment_s=10.0, reps=10)
SERVE_REL = 1e-4  # float32 on the card vs the port on the CPU, of max|ref|
BF16_REL_L2 = 0.05  # bf16 vs float32 (tests/test_metrics_infer.py's bound)
SISNR_DB, SDR_DB = 1e-3, 1e-2  # the tracker on the card vs on the CPU
# Phase 10: ConvTasNet training at the same width, the config's optimizer,
# clip and loss (configs/separation/convtasnet.yaml), phase 9's seeded
# weights; the step timed at B=8 x 4 s (BENCH_CLEAN_r05.json's "training
# step" lines), checked on B=2 x 1 s; a short fit over phase 8's split.
TRAIN = dict(seed=0, lr=1e-3, clip=5.0, batch=8, crop_s=4.0, reps=10, warmup=3,
             check_batch=2, check_s=1.0, bf16_steps=6, fit_samples=8, fit_batch=2,
             fit_epochs=2)
TRAIN_LOSS_REL = 1e-5  # one float32 step, the card vs the CPU
TRAIN_GRAD_REL = 1e-4  # of max|g_cpu|: the clipped gradients Adam takes
# Phase 11: the separation zoo at the full width of the model node of each
# configs/separation/*.yaml but convtasnet.yaml (written out here, as
# SERVE's; the CPU tests hold these to the files), in porting order; each
# built through the config's ``_target_``; held to the CPU on a 2 s crop
# (the call's time: each model's CPU forward of 4 s took up to 17 s on the
# card's 8-core host).
ZOO_MODELS = {
    "DPRNNTasNet": dict(in_channels=512, out_channels=64, hidden_channels=128, kernel_size=4,
                        rnn_type="LSTM", norm="gln", dropout=0, bidirectional=False,
                        num_layers=4, K=250, num_spks=2, sample_rate=SR),
    "SuDORMRF": dict(out_channels=256, in_channels=512, num_blocks=16, upsampling_depth=5,
                     enc_kernel_size=21, enc_num_basis=512, num_sources=2, sample_rate=SR),
    "AFRCNN": dict(out_channels=512, in_channels=512, num_blocks=16, upsampling_depth=5,
                   enc_kernel_size=41, enc_num_basis=512, num_sources=2, sample_rate=SR),
    "TDANet": dict(out_channels=128, in_channels=512, num_blocks=16, upsampling_depth=5,
                   enc_kernel_size=2, num_sources=2, sample_rate=SR),
    "DPTNetModel": dict(channel=64, kernel_size=4, stride=2, num_spk=2, layer=6,
                        bidirectional=True, unit=128, att_heads=4, activation="relu",
                        segment_size=360, nonlinear="relu", sample_rate=SR),
    "BSRNN": dict(sample_rate=SR, win=512, stride=128, feature_dim=128, num_repeat=12,
                  num_output=2),
    "TFGridNet": dict(input_dim=64, n_srcs=2, n_fft=512, stride=128, window="hann", n_imics=1,
                      n_layers=6, lstm_hidden_units=192, attn_n_head=4, attn_approx_qk_dim=512,
                      emb_dim=48, emb_ks=4, emb_hs=1, activation="prelu", eps=1.0e-5,
                      sample_rate=SR),
    "MossFormer": dict(kernel_size=16, stride=8, bias=False, out_channels=512, in_channels=512,
                       num_blocks=24, d_model=512, attn_dropout=0.1, group_size=256,
                       query_key_dim=128, expansion_factor=4.0, causal=False, norm="ln",
                       num_spks=2),
    "MossFormer2": dict(kernel_size=16, stride=8, bias=False, out_channels=512, in_channels=512,
                        num_blocks=24, d_model=512, attn_dropout=0.1, group_size=256,
                        query_key_dim=128, expansion_factor=4.0, causal=False, norm="ln",
                        num_spks=2),
    "SkiMNet": dict(input_dim=64, causal=False, num_spk=2, nonlinear="relu", layer=6, unit=128,
                    segment_size=250, dropout=0.1, mem_type="hc", seg_overlap=True,
                    kernel_size=4, sample_rate=SR),
}
ZOO = dict(models=ZOO_MODELS, seed=0, crop_s=2.0, window_s=10.0, reps=3, warmup=1,
           segment_s=10.0, profile_reps=3,  # the recurrent models launch thousands of kernels a call
           schedule_s=0.25, bf16_cli="DPRNNTasNet")
ZOO_REL = 1e-4  # float32 on the card vs the port on the CPU, of max|ref| (SERVE_REL)
# Phases 11 and 13–15 in bf16 (``infer.precision``): each allowed model's
# served output within rel-L2 BF16_REL_L2 of the card's own float32 on the
# crop (tests/test_torch_bf16_{sep,enh}.py's gate), every module's dtypes
# on the card those of the CPU (which those tests hold to the JAX package's)
# on ``schedule_s`` of it; each allowed config's bf16 step held to its
# float32 steps by phase 10's rule.
BF16_REL_L2 = 0.05
# Phase 12: SkiM streaming, skim.yaml's widths made causal without segment
# overlap (the streamer's mode): 10 s of phase 8's first mixture at B=1 for
# each depth, and the first 10 s of ``batch`` mixtures micro-batched.
STREAMING = dict(model=dict(ZOO_MODELS["SkiMNet"], causal=True, seg_overlap=False), seed=0,
                 seconds=10.0, depths=(0, 2), batch=4, batch_depth=2)
STREAM_RTOL, STREAM_ATOL = 1e-3, 1e-4  # streamed vs offline (tests/test_model_zoo.py:93-121)
STREAM_STEP_ATOL = 1e-6  # stream(depth) vs step()
# Phase 13: the enhancement zoo, the model node of each configs/enhancement/
# *.yaml by config name (written out here; the CPU tests hold these to the
# files).
ENH_MODELS = {
    "fullband": ("Fullband", dict(num_freqs=257, hidden_size=512, sequence_model="LSTM",
                                  output_activate_function=False, look_ahead=2, n_fft=512,
                                  hop_length=256, win_length=512)),
    "fullsubnet": ("FullSubnet", dict(num_freqs=257, look_ahead=2, sequence_model="LSTM",
                                      fb_num_neighbors=0, sb_num_neighbors=15,
                                      fb_output_activate_function="ReLU",
                                      sb_output_activate_function=False,
                                      fb_model_hidden_size=512, sb_model_hidden_size=384,
                                      n_fft=512, hop_length=256, win_length=512)),
    "fullsubnet_plus": ("FullSubNet_Plus", dict(
        num_freqs=257, look_ahead=2, sequence_model="LSTM", fb_num_neighbors=0,
        sb_num_neighbors=15, fb_output_activate_function="ReLU",
        sb_output_activate_function=False, fb_model_hidden_size=512, sb_model_hidden_size=384,
        n_fft=512, hop_length=256, win_length=512, channel_attention_model="SE", output_size=2,
        subband_num=1)),
    "inter_subnet": ("Inter_SubNet", dict(num_freqs=257, look_ahead=2, sequence_model="LSTM",
                                          sb_num_neighbors=15, sb_output_activate_function=False,
                                          sb_model_hidden_size=384, n_fft=512, hop_length=256,
                                          win_length=512, sbinter_middle_hidden_times=0.8)),
    "fastfullsubnet": ("FastFullSubnet", dict(
        look_ahead=2, shrink_size=2, sequence_model="LSTM", encoder_input_size=257, num_mels=64,
        n_fft=512, hop_length=256, win_length=512, bottleneck_hidden_size=384,
        bottleneck_num_layers=2, noisy_input_num_neighbors=5, encoder_output_num_neighbors=0)),
    "dccrn": ("DCCRN", dict(rnn_units=256, masking_mode="E", use_clstm=True,
                            kernel_num=[32, 64, 128, 256, 256, 256], sample_rate=SR)),
    "frcrn": ("FRCRN", dict(complex=True, model_complexity=45, model_depth=14, log_amp=False,
                            padding_mode="zeros", win_len=640, win_inc=320, fft_len=640,
                            win_type="hann")),
    "bsrnn_espnet": ("BSRNNESPNet", dict(n_fft=960, hop_length=480, num_spk=1, num_channels=256,
                                         num_layers=12, target_fs=48000, causal=False)),
    "sudormrf": ("SuDORMRF", dict(out_channels=256, in_channels=512, num_blocks=8,
                                  upsampling_depth=7, enc_kernel_size=81, enc_num_basis=512,
                                  num_sources=1)),
    "gagnet": ("GaGNet", dict(fft_num=320, n_fft=320, hop_length=160, win_length=320)),
    "g2net": ("G2Net", dict(fft_num=320, n_fft=320, hop_length=160, win_length=320)),
    "taylorsenet": ("TaylorSENet", dict(fft_num=320, n_fft=320, hop_length=160,
                                        win_length=320)),
}
ENH = dict(models=ENH_MODELS, seed=0, crop_s=4.0, window_s=10.0, reps=3, warmup=1,
           eval_model="fullsubnet", schedule_s=0.25, bf16_cli="fullsubnet", segment_s=10.0)
# Phase 14: enhancement training, each config's loss and metric node
# (written out, as ENH_MODELS; the CPU tests hold them to the files) by
# config name, its Adam (lr 1e-3) and clip (5), float32. The step timed at
# the configs' batch and duration (2 x 4 s), held to the CPU on B=2 x 0.5 s,
# phase 15's window.
_CIRM_STFT = dict(n_fft=512, hop_length=256, win_length=512)
_GAG_STFT = dict(n_fft=320, hop_length=160, win_length=320)
ENH_LOSSES = {
    **{stem: (("FullbandLoss", _CIRM_STFT), ("FullbandEval", _CIRM_STFT))
       for stem in ("fullband", "fullsubnet", "fullsubnet_plus", "inter_subnet",
                    "fastfullsubnet")},
    "dccrn": (("DCCRNLoss", {}), ("DCCRNEval", {})),
    "sudormrf": (("DCCRNLoss", {}), ("DCCRNEval", {})),
    "frcrn": (("FRCRNLoss", {}), ("FRCRNEval", {})),
    "bsrnn_espnet": (("BSRNNESPNetLoss", {}), ("BSRNNESPNetEval", {})),
    "gagnet": (("GaGNetLoss", _GAG_STFT), ("GaGNetEval", _GAG_STFT)),
    "g2net": (("GaGNetLoss", _GAG_STFT), ("GaGNetEval", _GAG_STFT)),
    "taylorsenet": (("TaylorSENetLoss", _GAG_STFT), ("TaylorSENetEval", _GAG_STFT)),
}
PACK_REL = 1e-5  # a reloaded LSTM model vs the trained one, of max|out|
ENH_TRAIN = dict(losses=ENH_LOSSES, seed=0, lr=1e-3, clip=5.0, batch=2, crop_s=4.0, reps=3,
                 warmup=1, check_batch=2, check_s=0.5, fit_model="fullsubnet", fit_samples=4,
                 fit_epochs=2, bf16_steps=3)
# Phase 15: separation training, the model of each configs/separation/*.yaml
# but convtasnet.yaml (phase 10) at its full width (ZOO_MODELS) with the
# config's optimizer (written out, as the models; the CPU tests hold them to
# the files), clip 5 and PIT neg-SNR, float32, from phase 11's seeded
# weights: the step timed at the configs' B=2 x 4 s, held to the CPU by
# ``enh_step_check`` on B=2 x 0.5 s for every config at half its depth
# (``SEP_CHECK_DEPTH``, the repeated blocks; seeded alike): at full depth
# the CPU's sides of the ten checks took about 490 s of the call, which
# then ran within 45 s of its 1,200 s with the bf16 steps.
SEP_OPTIMIZERS = {  # config: (model, lr, weight decay), in porting order
    "sudormrf": ("SuDORMRF", 1e-3, 0.0),
    "afrcnn": ("AFRCNN", 1e-3, 0.0),
    "tdanet": ("TDANet", 1e-3, 0.0),
    "dptnet": ("DPTNetModel", 4e-4, 1e-5),  # a weight decay: the adamw path
    "mossformer": ("MossFormer", 1.5e-4, 0.0),
    "mossformer2": ("MossFormer2", 1.5e-4, 0.0),
    "bsrnn": ("BSRNN", 1e-3, 0.0),
    "tfgridnet": ("TFGridNet", 1e-3, 0.0),
    "skim": ("SkiMNet", 1e-3, 0.0),
    "dprnn": ("DPRNNTasNet", 1e-3, 0.0),
}
SEP_TRAIN = dict(configs=SEP_OPTIMIZERS, models=ZOO_MODELS, seed=0, clip=5.0, batch=2,
                 crop_s=4.0, reps=3, warmup=1, check_batch=2, check_s=0.5, bf16_steps=3)
SEP_CHECK_DEPTH = {"DPRNNTasNet": "num_layers", "SuDORMRF": "num_blocks",
                   "AFRCNN": "num_blocks", "TDANet": "num_blocks", "DPTNetModel": "layer",
                   "MossFormer": "num_blocks", "MossFormer2": "num_blocks", "BSRNN": "num_repeat",
                   "TFGridNet": "n_layers", "SkiMNet": "layer"}


def check_depth(name: str, args: dict) -> dict:
    """Model ``name``'s arguments at half the depth of ``args`` (at least 1):
    phase 15's check."""
    key = SEP_CHECK_DEPTH[name]
    return dict(args, **{key: max(1, args[key] // 2)})
# Phase 16: the evaluation sidecars on seeded graphs (no .onnx weights are in
# the repository): DNSMOS-shaped graphs at its inputs (the raw 9.01 s clip,
# and ``audio_melspec`` of it: (1, 900, 120)), a SigMOS-shaped graph at its
# 48 kHz features of the same clip, serialised with ``onnx_bytes`` and read
# back by the executor; ``wav_chunk_inference`` of a zoo model over a
# mixture; the composite measures' host time per 60 s mixture.
EVAL_SIDECARS = dict(seed=0, clip_s=9.01, reps=3, warmup=1, models=ZOO_MODELS,
                     chunk_model="SuDORMRF", chunk_s=20.0,
                     chunk=dict(target_length=4.0, hop_length=2.0, batch_size=4),
                     composite_s=60.0)
ONNX_REL = 1e-4  # the graphs on the card vs on the CPU, of max|ref| (TF32 off)
# Phase 17: the sidecar models at their published widths with seeded
# weights, each written in its checkpoint's own format: Whisper medium.en
# (an HF directory), speechbrain's spkrec-ecapa-voxceleb (embedding_model
# .ckpt) and the JAX package's PyanNet defaults (a pyannote lightning
# checkpoint).
WHISPER_MEDIUM_EN = dict(vocab_size=51864, n_mels=80, d_model=1024, encoder_layers=24,
                         decoder_layers=24, heads=16, ffn=4096, max_source_positions=1500,
                         max_target_positions=448)
SIDECAR_MODELS = dict(
    seed=0, whisper=WHISPER_MEDIUM_EN, tf_positions=32,
    ecapa=dict(n_feats=80, channels=1024, res2net_scale=8, se_channels=128,
               attention_channels=128, lin_neurons=192),
    pyannet=dict(n_classes=1, lstm_hidden=128, lstm_layers=2, ff_layers=2),
    embed_s=10.0, reps=3, segment_s=10.0)
SIDECAR_REL = 1e-4  # the card vs the port on the CPU, of max|ref| (TF32 off)
# Phase 18: the model variants no config takes, each at its config's full
# width with the flag flipped (ENH_MODELS): the fp32 forward against the
# CPU on a 2 s crop of phase 8's first mixture, the B=1 x 10 s forward, bf16
# where ``require_bf16`` allows the variant, the config's train step at
# B=2 x 4 s and one step held by ``enh_step_check`` on B=2 x 0.5 s (phase
# 14's window; the enhancement models have no SEP_CHECK_DEPTH, so full depth
# as in phase 14).
_GRU = dict(sequence_model="GRU")
VARIANT_FLAGS = {  # variant: (config stem, the flag)
    "dccrn-lstm": ("dccrn", dict(use_clstm=False)),
    "fullband-gru": ("fullband", _GRU),
    "fullsubnet-gru": ("fullsubnet", _GRU),
    "fastfullsubnet-gru": ("fastfullsubnet", _GRU),
    "fullsubnet_plus-gru": ("fullsubnet_plus", _GRU),
    # 161 bins → 79, 39, 19, 9, 4 through the five stride-2 gates: 64 · 4 =
    # 256, gagnet.yaml's d_feat.
    "gagnet-unet": ("gagnet", dict(is_u2=False)),
}
VARIANTS = dict(models=ENH_MODELS, flags=VARIANT_FLAGS, losses=ENH_LOSSES, seed=0, crop_s=2.0,
                window_s=10.0, reps=3, warmup=1, schedule_s=0.25, lr=1e-3, clip=5.0, batch=2,
                train_s=4.0, check_batch=2, check_s=0.5, bf16_steps=3)
# Phase 19: (a) the optimizer zoo: each of the 14 names over DPTNet's
# full-width parameters at 2 of its 6 layers (convolutions, LSTMs with a
# frozen bias_hh, MHA split into query, key and value leaves; the depth cut
# for the call's time), three steps of seeded float64
# gradients (the second ten times the others, the clip set to fire on it),
# the LR changed after the first (``set_learning_rate``), weight decay 0.1;
# the card in float64 within OPT_F64_REL · max|Δp64| of the CPU in float64,
# in float32 within max(OPT_F32_REL, 2 x the CPU's float32 distance from
# float64) · max|Δp64|; each optimizer's step time at that width. (b) a
# two-epoch ``Trainer.fit`` of enhancement SuDORMRF with lamb on
# ``RemixTrainDataset`` items built from phase 8's split, its stages timed
# by ``StageTimer``. (c) phase 6's banks written as a reference-style
# rir_save_*.pt, converted by ``scripts.import_rir_banks``, read back by
# ``BankRirOracle`` and through phase 7's mixture step on the card: equal to
# phase 7's from the same banks.
OPTIM_NAMES = ("adam", "adamw", "sgd", "rmsprop", "adagrad", "adadelta", "lamb", "lars", "radam",
               "adafactor", "novograd", "yogi", "adabelief", "lion")
ADAPTERS = dict(optim_model="DPTNetModel", models=dict(
                    ZOO_MODELS, DPTNetModel=dict(ZOO_MODELS["DPTNetModel"], layer=2)),
                seed=0, lr=1e-3, lr2=4e-4,
                weight_decay=0.1, reps=5, warmup=2, fit_model="sudormrf", enh_models=ENH_MODELS,
                losses=ENH_LOSSES, fit_optimizer="lamb", fit_samples=4, batch=2, remix_s=2.0,
                fit_epochs=2)
OPT_F64_REL = 1e-9  # of max|Δp64|: F64_REL, the step checks' float64 rule
OPT_F32_REL = 1e-5  # of max|Δp64|: TRAIN_LOSS_REL's floor for the float32 rule
MOMENT_DTYPES = ("mu_dtype", "accumulator_dtype", "dtype_momentum")  # optax's, by name
# Phase 20: the device mesh (ROADMAP A11), two replicas of the card (and
# ``make_mesh()`` where there are more cards), each sharded call against the
# unsharded call on the card: (a) the mixture step at the headline's shapes,
# (b) phase 6's banks, (c) phase 8's first mixture, (d) chunked inference
# of a 60 s mixture at the configs' widths, (e) the data-parallel train step
# at phase 10's and phase 14's batches. Budget: 60 s of the call.
MESH = dict(replicas=2, n_src=HEADLINE["n_src"], iters=3, chunk_s=60.0,
            chunk=dict(target_length=12.0, hop_length=4.0, batch_size=10),
            chunk_models={"convtasnet": ("ConvTasNet", SERVE["model"], 2),
                          "dccrn": ENH_MODELS["dccrn"] + (1,)},
            train={"convtasnet": ("ConvTasNet", SERVE["model"], 8),
                   "dccrn": ENH_MODELS["dccrn"] + (2,), "frcrn": ENH_MODELS["frcrn"] + (2,)},
            losses=ENH_LOSSES, crop_s=4.0, lr=1e-3, clip=5.0, reps=3, warmup=1, seed=0)
MESH_ATOL = 1e-6  # tests/test_pipeline_mesh.py:114-118: sharded tracks and banks
MESH_PCM = 1.01 / 32768  # one int16 step: generated WAVs (test_pipeline_mesh.py:191)
MESH_CHUNK_REL = 1e-5  # of max|ref|: chunked output against batch_size x replicas
# Phase 21: (a) the checkpoint-import CLI on seeded reference checkpoints at
# the configs' widths; (b) optax's keywords beyond the defaults, by phase 19
# (a)'s rule on its model; (c) the bf16 recurrent layers, the card against
# the CPU. Budget: 30 s of the call.
IMPORTS = {"convtasnet": ("ConvTasNet", SERVE["model"]),
           "tdanet": ("TDANet", ZOO_MODELS["TDANet"]),
           "dccrn": ENH_MODELS["dccrn"], "frcrn": ENH_MODELS["frcrn"]}
QUIRK_MODELS = ("TDANet", "DCCRN", "FRCRN")  # built with torch_compat=True from a .pth


def kernels_only(tree):
    """A mask function on a flax tree: the leaves of two or more axes."""
    return {k: kernels_only(v) if isinstance(v, dict) else np.ndim(v) > 1
            for k, v in tree.items()}


OPTIM_KEYWORDS = (  # (label, optimizer, keywords): each keyword in one case
    ("adam eps_root nesterov", "adam", dict(eps_root=1e-3, nesterov=True)),
    ("adam mu_dtype", "adam", dict(mu_dtype="bfloat16")),
    ("adamw mask", "adamw", dict(mask=kernels_only)),
    ("sgd accumulator_dtype", "sgd", dict(momentum=0.9, accumulator_dtype="bfloat16")),
    ("adadelta weight_decay_mask", "adadelta", dict(weight_decay_mask=kernels_only)),
    ("lion mu_dtype mask", "lion", dict(mu_dtype="bfloat16", mask=kernels_only)),
    ("lamb mask", "lamb", dict(mask=kernels_only)),
    ("lars weight_decay_mask trust_ratio_mask", "lars",
     dict(weight_decay_mask=kernels_only, trust_ratio_mask=kernels_only)),
    ("adafactor dtype_momentum weight_decay_mask", "adafactor",
     dict(momentum=0.9, dtype_momentum="bfloat16", weight_decay_rate=0.1,
          weight_decay_mask=kernels_only)),
)
RNN_LAYERS = {  # label: (kind, input, hidden, bidirectional, layers, (B, T))
    "lstm-fullsubnet-fb": ("LSTM", 257, 512, False, 2, (1, 626)),
    "lstm-dprnn-intra": ("LSTM", 64, 128, True, 1, (64, 250)),
    "gru-fullband": ("GRU", 257, 512, False, 2, (1, 626)),
    "gru-bidirectional": ("GRU", 64, 128, True, 1, (64, 250)),
}
IMPORT_FWD = dict(imports=IMPORTS, seed=0, crop_s=2.0, keywords=OPTIM_KEYWORDS,
                  rnn_layers=RNN_LAYERS, reps=5, warmup=2)
IMPORT_REL = 1e-4  # of max|ref|: the converted pack against its .pth on the card
RNN_BF16_REL = 1e-4  # rel-L2: a bf16 recurrent layer on the card against the CPU
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
    smi_version = subprocess.run(["nvidia-smi", "--version"], capture_output=True,
                                 text=True, timeout=60).stdout.strip().splitlines()
    nv_version = smi_version[0].split(":")[-1].strip() if smi_version else "?"
    # Phases 4, 6, 8 and 9 hold the card against the CPU: name the host's CPU.
    info = Path("/proc/cpuinfo")
    lines = info.read_text().splitlines() if info.exists() else []
    cpu = next((ln.split(":", 1)[1].strip() for ln in lines if ln.startswith("vendor_id")), "?")
    # ROADMAP C9: what could switch float32 matmuls to a reduced precision.
    knobs = {k: v for k, v in os.environ.items()
             if k.startswith(("TORCH", "NVIDIA_TF32", "CUBLAS", "CUDNN"))}
    model = next((ln.split(":", 1)[1].strip() for ln in lines if ln.startswith("model name")), "?")
    line = (f"env: python {sys.version.split()[0]} torch {torch.__version__} "
            f"cuda {torch.version.cuda} triton {triton_v} "
            f"nvcc-on-PATH {shutil.which('nvcc')} nvcc {nvcc} "
            f"({nvcc_v[-1] if nvcc_v else '?'}) device {props} "
            f"count {torch.cuda.device_count()} nvidia-smi {nv_version} host CPU {cpu} "
            f"({model}) {os.cpu_count()} cores, torch CPU capability "
            f"{torch.backends.cpu.get_cpu_capability()}, float32 matmul precision "
            f"{torch.get_float32_matmul_precision()}, environment {knobs}")
    print(line, flush=True)
    return torch.device("cuda", 0), smi, line


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
    return hold_kernel_cases(device, cases)


def hold_kernel_cases(device, cases, first_seed: int = 0):
    """Each kernel against its plain version, timed, on every case (tables,
    segment lengths, ramp shifts, span, nfft, offset, C, weights); the
    headline case also times K1's ramp form against the separate epilogue.
    Returns {case: {kernel: numbers}}."""
    from sonicsim_tpu_torch.ops import kernels

    results, ab = {}, None
    for seed, (name, case) in enumerate(cases.items(), first_seed):
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
    over BANK_ATOL·peak + BANK_RTOL·|cpu|, (source, channel, sample) of the
    max abs err)."""
    from sonicsim_tpu_torch.sim import render_bank_batched

    got = render_bank_batched(oracle, srcs, mic, channel, peak_normalize=False)
    ref = render_bank_batched(dataclasses.replace(oracle, device="cpu"), srcs, mic,
                              channel, peak_normalize=False)
    peak = float(np.abs(ref).max())
    err = np.abs(got - ref)
    excess = float((err - BANK_ATOL * peak - BANK_RTOL * np.abs(ref)).max())
    s, _, c, n = np.unravel_index(int(np.argmax(err)), err.shape)
    return float(err.max()), peak, excess, (int(s), int(c), int(n))


def _float64_mode():
    """A ``TorchFunctionMode`` under which every torch call computes in
    float64 (complex128): float32 tensor arguments are widened and float32
    dtype arguments read as float64, but for ``view``, whose dtype
    reinterprets bits (the tail noise's uniforms), whose result the next call
    widens (ROADMAP C9: the same port function as a higher-precision
    reference for both sides)."""
    import torch
    from torch.overrides import TorchFunctionMode
    from torch.utils._pytree import tree_map

    wide = {torch.float32: torch.float64, torch.complex64: torch.complex128}

    def up(v):
        if isinstance(v, torch.Tensor) and v.dtype in wide:
            return v.to(wide[v.dtype])
        return wide.get(v, v) if isinstance(v, torch.dtype) else v

    class Float64(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name == "view":
                return func(*args, **(kwargs or {}))
            if name == "float":
                func = torch.Tensor.double
            return func(*tree_map(up, args), **tree_map(up, kwargs or {}))

    return Float64()


def _bank_f64(oracle, channel, src, mic, where, label: str) -> None:
    """ROADMAP C9: the items of the source of the largest device-vs-CPU error
    rendered in float64 on the CPU (:func:`_float64_mode`), and the card's
    and the CPU float32's distances from it, at the error's sample and over
    the items. Prints one line."""
    from sonicsim_tpu_torch.sim import render_bank_batched

    cpu = dataclasses.replace(oracle, device="cpu")
    dev = render_bank_batched(oracle, [src], mic, channel, peak_normalize=False)
    f32 = render_bank_batched(cpu, [src], mic, channel, peak_normalize=False)
    with _float64_mode():
        f64 = render_bank_batched(cpu, [src], mic, channel, peak_normalize=False)
    f64 = np.asarray(f64, np.float64)
    _, c, n = where
    dist = {side: (float(abs(float(a[0, 0, c, n]) - f64[0, 0, c, n])),
                   float(np.abs(a.astype(np.float64) - f64).max()))
            for side, a in (("device", dev), ("cpu float32", f32))}
    print(f"bank[C9 {label} float64]: the source of the largest error rendered in float64 "
          f"on the CPU (value {f64[0, 0, c, n]:.9g} at channel {c}, sample {n}; peak "
          f"{np.abs(f64).max():.6g}); distance from it at that sample / over the source's "
          + "; ".join(f"{k} {v[0]:.3g} / {v[1]:.3g}" for k, v in dist.items()), flush=True)


def _op_trace():
    """A ``TorchFunctionMode`` that keeps, in ``.ops``, a CPU copy of every
    tensor each torch call returns, in call order (ROADMAP C9: the same
    Python code on two devices calls the same ops in the same order, so op
    i of one run pairs with op i of the other)."""
    import torch
    from torch.overrides import TorchFunctionMode

    class OpTrace(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.ops.append((getattr(func, "__name__", repr(func)),
                                     t.detach().to("cpu", copy=True)))
            return out

    return OpTrace()


def _bank_parting(oracle, channel, srcs, mic, where, label: str, trace_dir) -> None:
    """ROADMAP C9: the items of the source of the largest device-vs-CPU
    error, rendered again on both sides under :func:`_op_trace`, op by op:
    the first op whose integer or boolean output parts between the two
    sides, and the first float op off by more than 1e-5 of its magnitude;
    and the image delays within ±C9_WINDOW samples of the error
    (``delays_s·fs``, its floor, ``valid``, the tap block of
    ``image_source.tap_grid``; the nearest C9_PRINT and every one that
    parts). Prints one line; with ``trace_dir``, writes the whole trace
    and window to ``trace_dir/c9_<label>.json``."""
    import torch

    from sonicsim_tpu_torch.sim import bank_render
    from sonicsim_tpu_torch.sim.image_source import tap_grid

    s, c, n = where
    room = bank_render._bank_params(oracle)
    flat = bank_render._flatten_items(oracle, [srcs[s]], mic, channel, [90.0] * len(mic))
    traces, delays = {}, {}
    for side, dev in (("device", bank_render.resolve_device(oracle.device)),
                      ("cpu", torch.device("cpu"))):
        items = {k: torch.tensor(v, device=dev) for k, v in zip(
            ("srcs", "recvs", "normals", "chan_idx", "seeds"), flat)}
        items["chan_idx"], items["seeds"] = items["chan_idx"].long(), items["seeds"].long()
        with bank_render._full_float32():
            with _op_trace() as mode:
                bank_render._render_core(
                    items, room, n_bands=oracle.n_bands, channel_type=channel.channel_type,
                    channel_order=channel.channel_order, max_order=oracle.max_order,
                    sample_rate=oracle.sample_rate,
                    diffraction=bool(getattr(oracle.room, "diffraction", True)))
            delays_s, _, _, valid = bank_render._device_geometry(
                torch.tensor(room.dims, device=dev), items["srcs"], items["recvs"],
                oracle.max_order, room.ir_seconds)
            d = (delays_s[c] * oracle.sample_rate).cpu()
        traces[side] = mode.ops
        delays[side] = dict(d=d, floor=torch.floor(d), valid=valid[c].cpu(), blk=tap_grid(d)[1])
    rows, first_int, first_float = [], None, None
    for i, ((name, a), (name_c, b)) in enumerate(zip(traces["device"], traces["cpu"])):
        row = {"op": i, "name": name, "dtype": str(b.dtype), "shape": list(b.shape)}
        rows.append(row)
        if name != name_c or a.shape != b.shape or a.dtype != b.dtype:
            row["diverged"] = [name_c, list(a.shape), str(a.dtype)]
            break
        if b.is_floating_point() or b.is_complex():
            err = float((a - b).abs().max()) if b.numel() else 0.0
            ref = float(b.abs().max()) if b.numel() else 0.0
            row["max_abs_err"], row["max_abs"] = err, ref
            if first_float is None and err > 1e-5 * max(ref, 1e-30):
                first_float = row
        else:
            row["n_diff"] = int((a != b).sum())
            if row["n_diff"] and first_int is None:
                first_int = row
                row["where"] = torch.nonzero(a != b)[:8].tolist()

    dv, cp = delays["device"], delays["cpu"]
    near = (cp["d"] - n).abs()
    win = sorted(torch.nonzero(near <= C9_WINDOW)[:, 0].tolist(), key=lambda i: float(near[i]))
    keys = ("floor", "valid", "blk")
    window = [{"image": i, **{side: [float(v["d"][i])] + [int(v[k][i]) for k in keys]
                              for side, v in delays.items()}} for i in win]
    parts = {k: int((dv[k] != cp[k]).sum()) for k in keys}
    if trace_dir is not None:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        (Path(trace_dir) / f"c9_{label}.json").write_text(json.dumps(
            {"label": label, "source": s, "channel": c, "sample": n, "ops": rows,
             "window_columns": "d = delays_s*fs, floor(d), valid, block", "window": window}))
    # The window's images, nearest first (every one where the sides part):
    # image:d_cpu:d_device-d_cpu:floor:valid:block, or both sides' values.
    shown = []
    for row in window:
        a, b = row["device"], row["cpu"]
        if a[1:] != b[1:]:
            shown.append(f"{row['image']}:device{a}:cpu{b}")
        elif len(shown) < C9_PRINT:
            shown.append(f"{row['image']}:{b[0]:.3f}:{a[0] - b[0]:+.2g}:{b[1]}:{b[2]}:{b[3]}")
    off = " ".join(f"{r['op']}:{r['name']}:{r['max_abs_err'] / r['max_abs']:.2g}"
                   for r in rows if r.get("max_abs_err", 0.0) > 1e-4 * r.get("max_abs", 0.0))
    print(f"bank[C9 {label}]: largest error at source {s}, channel {c}, sample {n}; "
          f"{len(rows)} ops traced on both sides (the render's output max abs err "
          f"{rows[-1].get('max_abs_err')}); first integer/mask op that parts: "
          f"{json.dumps(first_int)}; first float op off by > 1e-5 of its magnitude: "
          f"{json.dumps(first_float)}; float ops off by > 1e-4 of their magnitude (op:name:"
          f"rel): {off}; image delays d = delays_s·fs of channel {c}: floor "
          f"parts at {parts['floor']}, valid at {parts['valid']}, block at {parts['blk']} "
          f"of {dv['d'].numel()}, max |d_device - d_cpu| "
          f"{float((dv['d'] - cp['d']).abs().max()):.3g} samples; {len(win)} within "
          f"±{C9_WINDOW} samples of the error (image:d:Δd:floor:valid:block): "
          f"{' '.join(shown)}", flush=True)


def phase_bank(device, cfg, trace_dir=None):
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
    err, peak, excess, where = _bank_vs_cpu(oracle, channel, ways[0][:cfg["n_check"]], mic)
    _bank_parting(oracle, channel, ways[0][:cfg["n_check"]], mic, where, "room", trace_dir)
    _bank_f64(oracle, channel, ways[0][where[0]], mic, where, "room")
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
    w_err, w_peak, w_excess, w_where = _bank_vs_cpu(w_oracle, w_channel,
                                                    ways[0][:cfg["n_check"]], mic)
    _bank_parting(w_oracle, w_channel, ways[0][:cfg["n_check"]], mic, w_where, "per-wall",
                  trace_dir)
    _bank_f64(w_oracle, w_channel, ways[0][w_where[0]], mic, w_where, "per-wall")
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


def bank_mixture_step(device, banks, ways, static, cfg):
    """Phase 7's mixture step over ``banks`` (moving) and ``static``:
    ``step(weights_form)`` and the padded banks' shape."""
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

    return step, tuple(banks_p.shape)


def phase_bank_mixture(device, banks, ways, static, cfg):
    """Phase 6's banks as the moving banks of the mixture step, and its static
    bank as the static RIRs, without leaving the device."""
    step, padded = bank_mixture_step(device, banks, ways, static, cfg)
    targets = list(cfg["speech_lufs"]) + list(cfg["static_lufs"])
    secs, lu, diff = _mixture_forms(device, step, targets, cfg["iters"])
    print(f"bank->mixture: {len(banks)} moving banks {padded} + "
          f"static {tuple(static[:, 0].shape)}, {cfg['duration']:.0f} s: fused "
          f"{secs['fused']:.4f} s/mixture, weights= {secs['weights']:.4f} "
          f"s/mixture; LUFS fused {[round(v, 4) for v in lu['fused']]} "
          f"weights= {[round(v, 4) for v in lu['weights']]} (targets "
          f"{targets}, tol {LUFS_TOL} LU); forms max abs diff {diff:.3g}",
          flush=True)


def generation_corpus(root: Path, cfg):
    """Phase 8's corpus: PCM16 WAVs at 16 kHz from ``default_rng(cfg["seed"])``,
    ``cfg["speakers"]`` speaker folders of ``cfg["utterances"]`` utterances,
    and noise and music clips, each an AM tone plus noise, with lengths drawn
    from the ``*_s`` ranges. Returns (speaker dirs, noise and music length
    manifests)."""
    from sonicsim_tpu_torch.dataset import scan_audio_lengths
    from sonicsim_tpu_torch.utils import write_wav

    rng = np.random.default_rng(cfg["seed"])

    def clip(path, lo, hi):
        n = int(rng.uniform(lo, hi) * SR)
        t = np.arange(n) / SR
        f0, fm = rng.uniform(120.0, 400.0), rng.uniform(2.0, 6.0)
        x = 0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.3 * np.sin(2 * np.pi * fm * t))
        write_wav(path, (x + 0.01 * rng.standard_normal(n)).astype(np.float32), SR)

    dirs = []
    for k in range(cfg["speakers"]):
        d = root / "speech" / f"spk{k:02d}"
        d.mkdir(parents=True)
        for i in range(cfg["utterances"]):
            clip(d / f"spk{k:02d}_{i:03d}.wav", *cfg["utt_s"])
        dirs.append(str(d))
    for kind in ("noise", "music"):
        (root / kind).mkdir()
        for i in range(cfg[kind]):
            clip(root / kind / f"{kind}{i:02d}.wav", *cfg[f"{kind}_s"])
    return dirs, scan_audio_lengths(root / "noise"), scan_audio_lengths(root / "music")


def generation_factory(cfg, device):
    """The CLI's ``synthetic_scene_factory`` (32 bands) on ``device`` (None
    for the card), at ``cfg["max_order"]`` (the CLI's is 4)."""
    from sonicsim_tpu_torch.scripts.generate_sonicset import synthetic_scene_factory

    base = synthetic_scene_factory(cfg["channel"], 1, None, cfg["seed"],
                                   n_bands=cfg["n_bands"], device=device)

    def factory(name):
        scene = base(name)
        if scene.oracle.max_order != cfg["max_order"]:
            scene.oracle = dataclasses.replace(scene.oracle, max_order=cfg["max_order"])
        return scene

    return factory


class _Latencies(logging.Handler):
    """Each mixture's seconds from its plan to its finish, from the log line
    ``generate_split`` writes as it finishes one."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seconds = []

    def emit(self, record):
        if "generated" in record.getMessage():
            self.seconds.append(float(record.args[2]))


def prepare_generation(device, cfg, root: Path) -> dict:
    """Phase 8's set-up: the corpus, and one warm-up mixture in a scene the
    timed runs do not use (cuFFT plans, the kernel library)."""
    from sonicsim_tpu_torch.dataset import UtteranceCache, generate_split

    name = None if device.type == "cuda" else str(device)
    t0 = time.perf_counter()
    dirs, noise, music = generation_corpus(root / "corpus", cfg)
    corpus_s = time.perf_counter() - t0
    factory = generation_factory(cfg, name)
    t0 = time.perf_counter()
    warm = generate_split(factory, [cfg["warm_scene"]], dirs, noise, music, root / "warm",
                          duration=cfg["duration"], base_seed=cfg["seed"], max_mixtures=1,
                          utterance_cache=UtteranceCache(sample_rate=SR, device=name))
    sync(device)
    check(len(warm) == 1, f"warm-up made {len(warm)} mixtures")
    return dict(root=root, dirs=dirs, noise=noise, music=music, factory=factory,
                device_name=name, corpus_s=corpus_s, warm_s=time.perf_counter() - t0)


def generation_runs(device, cfg, gen) -> dict:
    """The main path of phase 8: ``generate_split`` over the timed scenes
    (pipelined, a fresh utterance cache, pcm16) with the disk sink, again
    into a fresh root, and with the device sink. Per run: the folders, the
    wall, each mixture's latency (plan to finish), and the cache's hits and
    misses (all, and in the second scene)."""
    from sonicsim_tpu_torch.dataset import UtteranceCache, generate_split
    from sonicsim_tpu_torch.dataset import generate as generate_module

    log = logging.getLogger(generate_module.__name__)
    runs = {}
    for label, sink in (("disk", "disk"), ("disk2", "disk"), ("device", "device")):
        cache = UtteranceCache(sample_rate=SR, device=gen["device_name"])
        at_scene = {}

        def factory(name, cache=cache, at_scene=at_scene):
            at_scene[name] = cache.hits
            return gen["factory"](name)

        done, level = _Latencies(), log.level
        log.addHandler(done)
        log.setLevel(logging.INFO)
        try:
            t0 = time.perf_counter()
            produced = generate_split(factory, list(cfg["scenes"]), gen["dirs"],
                                      gen["noise"], gen["music"], gen["root"] / label,
                                      duration=cfg["duration"], base_seed=cfg["seed"],
                                      utterance_cache=cache, sink=sink)
            sync(device)
            wall = time.perf_counter() - t0
        finally:
            log.removeHandler(done)
            log.setLevel(level)
        runs[label] = dict(produced=produced, wall=wall, latency=done.seconds,
                           hits=cache.hits, misses=cache.misses,
                           second_scene_hits=cache.hits - at_scene[cfg["scenes"][-1]])
    return runs


def _track_names(n_moving: int) -> list:
    return ([f"moving_audio_{i + 1}.wav" for i in range(n_moving)]
            + ["noise_audio.wav", "music_audio.wav"])


def generation_case(plan, bank_len: int, n_ch: int):
    """Phase 3's ``generation`` case: the K1/K2 tables the mixture step of
    ``plan`` launches with, from the crossfade plans drawn from
    ``default_rng(plan.seed)`` speaker by speaker, as ``dispatch_mixture``
    draws them, and the bank's length."""
    from sonicsim_tpu_torch.ops import dynamic_interp_plan, segment_plan
    from sonicsim_tpu_torch.parallel import pad_moving_plans

    rng = np.random.default_rng(plan.seed)
    weights, offs, lens = [], [], []
    for sp, traj in zip(plan.speech_plans, plan.trajectories):
        idx, w = dynamic_interp_plan(np.asarray(traj), sp.total_samples, rng=rng)
        o, le, _ = segment_plan(idx)
        weights.append(w)
        offs.append(o)
        lens.append(le)
    _, w_p, off_p, len_p, max_seg = pad_moving_plans(
        [np.zeros((len(t), 1, 1), np.float32) for t in plan.trajectories],
        weights, offs, lens)
    return _blocked_case(off_p, len_p, max_seg, w_p.shape[-1], n_ch, bank_len, w_p)


def check_generation(device, cfg, gen, runs, smi):
    """Phase 8's gates on the runs; prints the phase's lines. Returns phase
    3's ``generation`` case, from the first timed mixture."""
    import torch

    from sonicsim_tpu_torch.bridge import plan_from_json
    from sonicsim_tpu_torch.dataset import UtteranceCache, render_mixture
    from sonicsim_tpu_torch.ops import integrated_loudness
    from sonicsim_tpu_torch.utils import read_wav

    t = int(SR * cfg["duration"])
    n_mix = len(cfg["scenes"]) * (cfg["speakers"] // 3)
    disk, disk2, dev = runs["disk"]["produced"], runs["disk2"]["produced"], runs["device"]["produced"]
    check(len(disk) == len(disk2) == len(dev) == n_mix,
          f"mixtures made: {len(disk)}, {len(disk2)}, {len(dev)}; want {n_mix}")
    check([p.name for p in disk] == [p.name for p in disk2] == [p.name for p in dev],
          "the runs made different mixtures")
    drawer = next((m for m in ("PIL", "matplotlib") if importlib.util.find_spec(m)), None)
    worst_lu, plans = 0.0, []
    for folder, again in zip(disk, disk2):
        plan = plan_from_json(folder / "mixture_plan.json")
        plans.append(plan)
        names = _track_names(len(plan.speech_plans))
        want = set(names) | {"json_data.json", "mixture_plan.json",
                             f"rir_bank_{cfg['channel']}.npz"}
        have = {p.name for p in folder.iterdir()}
        check(want <= have, f"{folder.name}: missing {sorted(want - have)}")
        check(("trace.png" in have) == (drawer is not None),
              f"{folder.name}: trace.png {'missing' if drawer else 'written'} "
              f"with drawer {drawer}")
        meta = json.loads((folder / "json_data.json").read_text())
        scales = meta.get("pcm16_peak_scale", {})
        targets = list(plan.lufs_speech) + [plan.lufs_noise, plan.lufs_music]
        for name, target in zip(names, targets):
            wav, sr = read_wav(folder / name)
            check(sr == SR and wav.shape == (2, t), f"{folder.name}/{name}: {wav.shape}")
            lu = float(integrated_loudness(torch.from_numpy(wav).to(device), SR))
            lu -= 20.0 * np.log10(scales.get(name, 1.0))
            worst_lu = max(worst_lu, abs(lu - target))
            check(abs(lu - target) <= GEN_LU_TOL,
                  f"{folder.name}/{name}: {lu:.4f} LUFS, target {target:.4f}")
        for name in names + ["json_data.json", "mixture_plan.json"]:
            check((folder / name).read_bytes() == (again / name).read_bytes(),
                  f"{folder.name}/{name}: the two disk-sink runs differ")
        with np.load(folder / f"rir_bank_{cfg['channel']}.npz") as a, \
                np.load(again / f"rir_bank_{cfg['channel']}.npz") as b:
            check(all(np.array_equal(a[k], b[k]) for k in a.files),
                  f"{folder.name}: the two disk-sink runs' banks differ")
    check(all(not any(p.iterdir()) for p in dev), "the device sink wrote files")
    hits_b = runs["disk"]["second_scene_hits"]
    check(hits_b > 0, "no utterance-cache hit in the second scene")

    # The device sink's tracks, measured on the device.
    cache = UtteranceCache(sample_rate=SR, device=gen["device_name"])
    worst_dev = 0.0
    for plan in plans:
        res = render_mixture(gen["factory"](plan.room), plan, gen["root"] / "sink",
                             cache=cache, sink="device")
        tracks = res["tracks"].to(torch.float32) / 32768.0 / res["peak_scales"][:, None, None]
        targets = list(plan.lufs_speech) + [plan.lufs_noise, plan.lufs_music]
        for x, target in zip(tracks, targets):
            err = abs(float(integrated_loudness(x, SR)) - target)
            worst_dev = max(worst_dev, err)
            check(err <= LUFS_TOL, f"device-sink track {err:.4f} LU off its target")

    # One mixture again on the CPU, float32 on both sides.
    plan = plans[0]
    outs = {}
    for side, factory in (("device", gen["factory"]),
                          ("cpu", generation_factory(cfg, "cpu"))):
        t0 = time.perf_counter()
        render_mixture(factory(plan.room), plan, gen["root"] / f"f32_{side}",
                       wav_encoding="float32")
        outs[side] = (gen["root"] / f"f32_{side}", time.perf_counter() - t0)
    cpu_err, cpu_ref = 0.0, 0.0
    for name in _track_names(len(plan.speech_plans)):
        got, _ = read_wav(outs["device"][0] / name)
        ref, _ = read_wav(outs["cpu"][0] / name)
        err, peak = float(np.abs(got - ref).max()), float(np.abs(ref).max())
        check(err <= SLICE_REL * peak,
              f"{name}: the device and the CPU differ by {err} (max|ref| {peak})")
        cpu_err, cpu_ref = max(cpu_err, err / peak), max(cpu_ref, peak)
    for name in ("json_data.json", "mixture_plan.json"):
        check((outs["device"][0] / name).read_bytes() == (outs["cpu"][0] / name).read_bytes(),
              f"{name}: the device and the CPU differ")

    def per_mix(run):
        return (run["wall"] / n_mix, statistics.median(run["latency"]))

    (dw, dm), (dw2, dm2), (vw, vm) = (per_mix(runs[k]) for k in ("disk", "disk2", "device"))
    print(f"generation: {n_mix} x {cfg['duration']:.0f} s {cfg['channel']} mixtures, "
          f"{cfg['n_bands']} bands, order {cfg['max_order']}, pipelined, utterance "
          f"cache, pcm16 (corpus {gen['corpus_s']:.3f} s to write, warm-up mixture "
          f"{gen['warm_s']:.3f} s): s per mixture = wall/{n_mix}, and the median "
          f"latency of a mixture (plan to finish): disk sink {dw:.4f} s, {dm:.4f} s; "
          f"again {dw2:.4f} s, {dm2:.4f} s; device sink {vw:.4f} s, {vm:.4f} s "
          f"(latencies: disk {runs['disk']['latency']}, device "
          f"{runs['device']['latency']}); cache hits/misses "
          f"{runs['disk']['hits']}/{runs['disk']['misses']} ({hits_b} hits in the second "
          f"scene); device ops per mixture: see --profile; {smi}", flush=True)
    print(f"generation gates: 4 folders x 5 WAVs of 2 x {t}, json, plan, bank; loudness "
          f"read back within {worst_lu:.4f} LU (tol {GEN_LU_TOL}); device-sink tracks "
          f"within {worst_dev:.4f} LU on the device (tol {LUFS_TOL}); the two disk-sink "
          f"runs byte-identical; the device sink wrote nothing; mixture "
          f"{disk[0].parent.name}/{disk[0].name} on the device ({outs['device'][1]:.3f} "
          f"s) vs the CPU ({outs['cpu'][1]:.3f} s), float32: max abs err / "
          f"max|ref| {cpu_err:.3g} (tol {SLICE_REL}; largest max|ref| "
          f"{cpu_ref:.3g}); trace: "
          + (f"drawn by {drawer}" if drawer else
             "neither PIL nor matplotlib is importable, trace.png left out"),
          flush=True)
    with np.load(disk[0] / f"rir_bank_{cfg['channel']}.npz") as z:
        _, _, n_ch, bank_len = z["rirs"].shape
    return generation_case(plans[0], int(bank_len), int(n_ch))


def seeded_flax(tree: dict, seed: int) -> dict:
    """A flax parameter tree's shapes filled from ``default_rng(seed)`` as
    float32 numpy, leaves drawn in sorted key order: kernels N(0, 1/fan_in),
    gains (``gamma``, ``scale``, ``g``, …) 1 + N(0, 0.01), PReLU slopes 0.25,
    biases, betas and offsets N(0, 0.01)."""
    rng = np.random.default_rng(seed)

    def draw(node):
        out = {}
        for key in sorted(node):
            v = node[key]
            if isinstance(v, dict):
                out[key] = draw(v)
                continue
            if key == "kernel":
                a = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
            elif "gamma" in key or key in ("scale", "g"):
                a = 1.0 + 0.1 * rng.standard_normal(v.shape)
            elif key in ("alpha", "attn_prelu", "prelu_alpha") or key.startswith("prelu_"):
                a = np.full(v.shape, 0.25)
            else:
                a = 0.1 * rng.standard_normal(v.shape)
            out[key] = a.astype(np.float32)
        return out

    return draw(tree)


def seeded_convtasnet(model_cfg, seed: int) -> dict:
    """ConvTasNet weights from :func:`seeded_flax` in the JAX package's flax
    layout; the tree's shapes come from the port's model through the
    bridge."""
    from sonicsim_tpu_torch import bridge
    from sonicsim_tpu_torch.models import ConvTasNet

    return seeded_flax(bridge.convtasnet_flax_params(
        ConvTasNet(**model_cfg, device="cpu").state_dict()), seed)


def seeded_zoo(name: str, model_args: dict, seed: int):
    """Zoo model ``name`` built on the CPU through the config's ``_target_``
    (``sonicsim_tpu.models.<name>``, read as the port's), with
    :func:`seeded_flax` weights in the JAX package's flax layout carried in
    by the bridge."""
    from sonicsim_tpu_torch.models import base
    from sonicsim_tpu_torch.utils import instantiate

    model = instantiate({"_target_": f"sonicsim_tpu.models.{name}", **model_args}, device="cpu")
    args = model.model_args()
    params = seeded_flax(base.to_flax(name, model.state_dict(), args), seed)
    model.load_state_dict(base.to_state_dict(name, params, args))
    return model.eval()


def seeded_sinc(n_filters: int, seed: int) -> tuple:
    """A SincNet's learned cutoffs (``low_hz``, ``band_hz``, float32 numpy)
    spread over the band from ``default_rng(seed)``: lows uniform in
    [0, 6000) Hz, bandwidths in [50, 1500) Hz."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 6000.0, n_filters).astype(np.float32),
            rng.uniform(50.0, 1500.0, n_filters).astype(np.float32))


def vad_spans_held(got, ref, times, tol: float, onset: float = 0.5,
                   offset: float = 0.5) -> bool:
    """Whether frame probabilities ``got`` give ``ref``'s binarised spans
    once every frame whose ``ref`` probability lies within ``tol`` of
    ``onset`` or ``offset`` takes ``ref``'s value: two sides within ``tol``
    of each other may part only at such a frame."""
    from sonicsim_tpu_torch.models.pyannet import binarize_activations

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    near = (np.abs(ref - onset) <= tol) | (np.abs(ref - offset) <= tol)
    held = np.where(near, ref, got)
    return (binarize_activations(held, times, onset, offset)
            == binarize_activations(ref, times, onset, offset))


def serving_models(device, cfg, root: Path):
    """The seeded weights through the CLI's own path: the port's model on the
    CPU, ``save_model`` to a pack, ``from_pretrain`` on ``device``. Returns
    (CPU model, model on the device, pack path)."""
    from sonicsim_tpu_torch import bridge
    from sonicsim_tpu_torch.models import ConvTasNet, from_pretrain, save_model

    cpu = ConvTasNet(**cfg["model"], device="cpu")
    cpu.load_state_dict(bridge.convtasnet_state_dict(seeded_convtasnet(cfg["model"], cfg["seed"])))
    path = root / "convtasnet.pkl"
    save_model(cpu.eval(), path)
    return cpu, from_pretrain(path, device=device), path


def _timed_metric(fn, clocks: dict, name: str):
    """``fn`` (a tracker sidecar) adding its host seconds to ``clocks[name]``."""
    def timed(ref, est, sample_rate):
        t0 = time.perf_counter()
        try:
            return fn(ref, est, sample_rate)
        finally:
            clocks[name] = clocks.get(name, 0.0) + time.perf_counter() - t0

    timed.backend = fn.backend
    return timed


def _peak_mib(device, fn) -> float | None:
    """Peak extra device memory of one call of ``fn``, in MiB (the card)."""
    import torch

    if device.type != "cuda":
        return None
    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    fn()
    sync(device)
    return (torch.cuda.max_memory_allocated(device) - base) / 2**20


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


def bf16_dtypes(model, x) -> dict:
    """Module name → the floating dtypes it returned in ``model``'s bf16
    forward of ``x`` (``infer.precision``'s call, forward hooks)."""
    import torch

    from sonicsim_tpu_torch.infer.precision import bf16_call, cast_state

    def dtypes(out) -> set:
        if isinstance(out, (tuple, list)):
            return set().union(*(dtypes(o) for o in out)) if out else set()
        return {str(out.dtype)} if torch.is_tensor(out) and out.is_floating_point() else set()

    seen, hooks = {}, []
    for name, m in model.named_modules():
        hooks.append(m.register_forward_hook(
            lambda mod, args, out, n=name: seen.setdefault(n, set()).update(dtypes(out))))
    try:
        with torch.inference_mode():
            bf16_call(model, cast_state(model), x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def serve_bf16(device, name, cpu, model, crop, got32, x10, cfg) -> dict:
    """Phases 11 and 13: ``model`` in bf16 through ``make_forward(model,
    bf16=True)`` (the CLIs' ``--bf16``): its served output on ``crop``
    against the card's float32 one ``got32`` (rel-L2 within BF16_REL_L2,
    and not 0), its modules' dtypes on the card against the CPU model's on
    ``cfg["schedule_s"]`` of the crop, and its 10 s forward's time and peak
    extra memory. A refused model is shown to raise; returns its reason."""
    import torch

    from sonicsim_tpu_torch.infer.precision import BF16_MODELS
    from sonicsim_tpu_torch.scripts.common import make_forward

    try:
        fwd = make_forward(model, bf16=True)
    except NotImplementedError as e:
        check(name not in BF16_MODELS, f"{name}: bf16 refused but listed: {e}")
        return dict(refused=str(e))
    check(name in BF16_MODELS, f"{name}: bf16 taken but not listed")
    got = fwd(crop.to(device)).cpu()
    rel = _rel_l2(got, got32)
    check(got.dtype == torch.float32 and bool(torch.isfinite(got).all())
          and 0 < rel <= BF16_REL_L2,
          f"{name} bf16 vs float32 on the card: rel-L2 {rel} (gate {BF16_REL_L2}), dtype "
          f"{got.dtype}")
    short = crop[:, :int(cfg["schedule_s"] * SR)]
    card, host = bf16_dtypes(model, short.to(device)), bf16_dtypes(cpu, short)
    differ = sorted(n for n in set(card) | set(host) if card.get(n) != host.get(n))
    check(not differ, f"{name} bf16 dtypes on the card vs the CPU differ at {differ[:5]}: "
          f"{[(card.get(n), host.get(n)) for n in differ[:5]]}")
    f32 = sum(1 for v in card.values() if "torch.float32" in v)
    ms = median_ms(lambda: fwd(x10), device, reps=cfg["reps"], warmup=cfg["warmup"])
    mib = _peak_mib(device, lambda: fwd(x10))
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          f"{name}: bf16 serving changed the stored weights")
    return dict(rel=rel, ms=ms, audio_s_per_s=cfg["window_s"] / (ms / 1e3), peak_mib=mib,
                modules=len(card), f32_modules=f32)


def fft_dtypes(device) -> str:
    """What ``torch.fft.rfft`` does with each floating dtype on ``device``
    (a bfloat16 spectrum is a fault the port must not reach: its STFTs
    multiply by a float32 window first, as the JAX package's do)."""
    import torch

    seen = []
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        try:
            out = torch.fft.rfft(torch.ones(2, 512, device=device, dtype=dtype))
            seen.append(f"{dtype} -> {out.dtype}")
        except RuntimeError as e:
            seen.append(f"{dtype} raises ({str(e).splitlines()[0][:90]})")
    return "; ".join(seen)


def bf16_line(b: dict, cfg) -> str:
    """``serve_bf16``'s readings as phases 11 and 13 print them."""
    if "refused" in b:
        return f"bf16 refused: {b['refused']}"
    return (f"bf16 (make_forward(bf16=True)): rel-L2 {b['rel']:.4g} from the card's fp32 on the "
            f"crop (gate {BF16_REL_L2}); dtypes of all {b['modules']} modules on the card those "
            f"of the CPU ({b['f32_modules']} of them return float32); B=1 x "
            f"{cfg['window_s']:g} s: {b['ms']:.4f} ms = {b['audio_s_per_s']:.1f} audio-s/s "
            f"(CUDA-event median of {cfg['reps']} after {cfg['warmup']}), peak extra memory "
            f"{b['peak_mib'] if b['peak_mib'] is None else round(b['peak_mib'], 1)} MiB")


def bf16_cli_check(device, name, pack: Path, mix_path: Path, out_dir: Path, n_out: int,
                   segment_s: float) -> str:
    """The inference CLI on ``pack`` with and without ``--bf16`` over the
    mixture at ``mix_path``: the bf16 tracks finite and within rel-L2
    BF16_REL_L2 of the float32 ones."""
    from sonicsim_tpu_torch.scripts import inference
    from sonicsim_tpu_torch.utils import read_wav

    walls, tracks = {}, {}
    for bf16 in (False, True):
        out = out_dir / f"cli_{'bf16' if bf16 else 'fp32'}"
        argv = ["--model_path", str(pack), "--mix", str(mix_path), "--out_dir", str(out),
                "--segment_seconds", str(segment_s), "--device", str(device)] + ["--bf16"] * bf16
        t0 = time.perf_counter()
        inference.main(argv)
        walls[bf16] = time.perf_counter() - t0
        tracks[bf16] = np.concatenate([read_wav(out / f"s{i + 1}_est.wav")[0]
                                       for i in range(n_out)])
    a, b = tracks[True].astype(np.float64), tracks[False].astype(np.float64)
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    check(np.isfinite(a).all() and rel <= BF16_REL_L2,
          f"{name} inference --bf16 vs fp32: rel-L2 {rel} (gate {BF16_REL_L2})")
    return (f"inference CLI --bf16 on {pack.name} over the {a.shape[-1] / SR:g} s mixture: "
            f"{walls[True]:.3f} s (fp32 {walls[False]:.3f} s, load and WAV I/O included), its "
            f"tracks rel-L2 {rel:.4g} from the fp32 CLI's (gate {BF16_REL_L2})")


def train_bf16(device, what: str, fresh, x, y, f32_trace: list, cfg) -> dict:
    """Phases 14 and 15: ``fresh(device, precision="bf16")``'s step, or its
    refusal: ``cfg["bf16_steps"]`` steps on the batch held to the float32
    steps ``f32_trace`` from the same weights by phase 10's rule (every loss
    finite and falling, the first bf16 loss within 0.1·|f32| + 0.5 of the
    first float32 one), master weights float32, then its time and peak
    extra memory."""
    import torch

    try:
        model, step = fresh(device, precision="bf16")
    except NotImplementedError as e:
        return dict(refused=str(e))
    trace = [float(step(x, y)) for _ in range(cfg["bf16_steps"])]
    check(all(np.isfinite(t).all() and t[-1] < t[0] for t in (f32_trace, trace)),
          f"{what}: the loss did not fall: fp32 {f32_trace}, bf16 {trace}")
    check(abs(trace[0] - f32_trace[0]) < 0.1 * abs(f32_trace[0]) + 0.5,
          f"{what}: first bf16 loss {trace[0]} vs fp32 {f32_trace[0]} (tests/test_train.py's bound)")
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          f"{what}: bf16 master weights are not float32")
    ms = median_ms(lambda: step(x, y), device, reps=cfg["reps"], warmup=cfg["warmup"])
    mib = _peak_mib(device, lambda: step(x, y))
    del model, step
    return dict(ms=ms, peak_mib=mib, trace=trace, f32_trace=f32_trace)


def train_bf16_line(b: dict, cfg, audio_s: float) -> str:
    if "refused" in b:
        return f"bf16 refused: {b['refused']}"
    return (f"bf16: {b['ms']:.4f} ms/step = {audio_s / (b['ms'] / 1e3):.1f} audio-s/s, peak "
            f"extra memory {b['peak_mib'] if b['peak_mib'] is None else round(b['peak_mib'], 1)} "
            f"MiB; {cfg['bf16_steps']} steps on the batch fp32 "
            f"{[round(v, 4) for v in b['f32_trace']]}, bf16 {[round(v, 4) for v in b['trace']]} "
            f"(phase 10's rule)")


def phase_serving(device, cfg, folders, root: Path, smi) -> None:
    """Phase 9: ConvTasNet from a pack on the device; its forward against the
    CPU, its throughput, the inference CLI on phase 8's first mixture, and
    the remix evaluation over phase 8's disk-sink split."""
    import csv

    import torch

    from sonicsim_tpu_torch.dataset import MovingTestEvalDataset
    from sonicsim_tpu_torch.metrics import MetricsTracker
    from sonicsim_tpu_torch.scripts import audio_test, inference
    from sonicsim_tpu_torch.scripts.common import make_forward, pesq_columns
    from sonicsim_tpu_torch.scripts.test import metadata_segments
    from sonicsim_tpu_torch.utils import read_wav, write_wav

    root.mkdir()
    cpu, model, pack = serving_models(device, cfg, root)
    n_params = sum(p.numel() for p in model.parameters())
    check(cfg.get("params") in (None, n_params), f"ConvTasNet has {n_params} parameters")
    # Each generated mixture: its five tracks summed (binaural), and mono.
    mixes = [np.sum([read_wav(f / n)[0] for n in sorted(p.name for p in f.glob("*_audio*.wav"))],
                    axis=0, dtype=np.float32) for f in folders]
    mono = [m.mean(axis=0) for m in mixes]
    t_mix, t_crop = mono[0].shape[-1], int(cfg["crop_s"] * SR)
    fwd32, fwd16 = make_forward(model), make_forward(model, bf16=True)

    crop = torch.from_numpy(mono[0][None, :t_crop].copy())
    with torch.inference_mode():
        ref = cpu(crop)
    got = fwd32(crop.to(device)).cpu()
    crop_err, crop_ref = float((got - ref).abs().max()), float(ref.abs().max())
    check(crop_err <= SERVE_REL * crop_ref,
          f"ConvTasNet on the device vs the CPU: max abs err {crop_err} (max|ref| {crop_ref})")

    per = -(-cfg["batch"] // len(mono))
    step = (t_mix - t_crop) // per
    xb = torch.from_numpy(np.stack([mono[k % len(mono)][(k // len(mono)) * step:][:t_crop]
                                    for k in range(cfg["batch"])])).to(device)
    x60 = torch.from_numpy(mono[0][None].copy()).to(device)
    runs = {"fp32 60 s": (fwd32, x60), "bf16 60 s": (fwd16, x60),
            f"bf16 B={cfg['batch']} x {cfg['crop_s']:g} s": (fwd16, xb)}
    outs, stats = {}, {}
    for name, (fn, x) in runs.items():
        outs[name] = fn(x)
        sync(device)
        check(tuple(outs[name].shape) == (x.shape[0], cfg["model"]["num_spks"], x.shape[1]),
              f"{name}: output shape {tuple(outs[name].shape)}")
        check(bool(torch.isfinite(outs[name]).all()), f"{name}: output not finite")
        ms = median_ms(lambda fn=fn, x=x: fn(x), device, reps=cfg["reps"], warmup=2)
        stats[name] = (ms, x.numel() / SR / (ms / 1e3), _peak_mib(device, lambda fn=fn, x=x: fn(x)))
    names = list(runs)
    rel60 = _rel_l2(outs[names[1]], outs[names[0]])
    rel_b = _rel_l2(outs[names[2]], fwd32(xb))
    check(rel60 < BF16_REL_L2 and rel_b < BF16_REL_L2,
          f"bf16 vs fp32 rel-L2 {rel60}, {rel_b} (bound {BF16_REL_L2})")
    print(f"serving: ConvTasNet N={cfg['model']['N']} H={cfg['model']['H']} "
          f"X={cfg['model']['X']} R={cfg['model']['R']}, {n_params} parameters, from "
          f"{pack.name} via from_pretrain; fp32 vs the port on the CPU on a "
          f"{cfg['crop_s']:g} s crop: max abs err {crop_err:.3g} of max|ref| {crop_ref:.3g} "
          f"(tol {SERVE_REL}·max|ref|); bf16 vs fp32 rel-L2 {rel60:.4f} (60 s), "
          f"{rel_b:.4f} (batch) (tol {BF16_REL_L2}) | "
          + " | ".join(f"{k}: {v[0]:.4f} ms = {v[1]:.1f} audio-s/s, peak extra "
                       f"memory {v[2] if v[2] is None else round(v[2], 1)} MiB"
                       for k, v in stats.items())
          + f" (median of {cfg['reps']}); {smi}", flush=True)

    mix_path = root / "mix.wav"
    write_wav(mix_path, mixes[0], SR, encoding="float32")
    walls = {}
    for label, extra in (("fp32", []), ("bf16", ["--bf16"])):
        argv = ["--model_path", str(pack), "--mix", str(mix_path), "--out_dir",
                str(root / f"sep_{label}"), "--segment_seconds", str(cfg["segment_s"]),
                "--device", str(device)] + extra
        inference.main(argv)  # warm-up
        t0 = time.perf_counter()
        inference.main(argv)
        walls[label] = time.perf_counter() - t0
        t0 = time.perf_counter()
        inference.separate(model, mono[0], SR, cfg["segment_s"], bf16=bool(extra))
        walls[label + " separate"] = time.perf_counter() - t0
        for i in range(cfg["model"]["num_spks"]):
            est, _ = read_wav(root / f"sep_{label}" / f"s{i + 1}_est.wav")
            check(est.shape == (1, t_mix) and bool(np.isfinite(est).all()),
                  f"inference {label}: s{i + 1}_est.wav {est.shape}")
    print(f"serving[inference CLI]: one {t_mix / SR:g} s generated mixture "
          f"(binaural, downmixed by the CLI), {cfg['segment_s']:g} s windows, "
          f"stitched: wall per mixture after a warm-up, load and WAV I/O included: "
          f"fp32 {walls['fp32']:.4f} s, bf16 {walls['bf16']:.4f} s; separate() "
          f"alone: fp32 {walls['fp32 separate']:.4f} s, bf16 "
          f"{walls['bf16 separate']:.4f} s", flush=True)

    split = folders[0].parent.parent
    ds = MovingTestEvalDataset(str(split), seed=cfg["seed"])
    check(sorted(ds.data_dirs) == sorted(str(f) for f in folders),
          f"the split's leaf folders are not the generated mixtures: {ds.data_dirs}")
    segments = {str(f): metadata_segments(str(f), t_mix) for f in folders}
    clocks: dict = {}
    columns = {k: _timed_metric(fn, clocks, k) for k, fn in pesq_columns().items()}
    t0 = time.perf_counter()
    res = audio_test.evaluate_remix(model, split, root / "results" / "metrics_remix-noise.csv",
                                    segments=segments, extra_metrics=columns, seed=cfg["seed"])
    wall = time.perf_counter() - t0
    want = sum(e - s > audio_test.MIN_SEGMENT for spans in segments.values() for s, e in spans)
    with open(res["csv"]) as f:
        table = list(csv.DictReader(f))
    scored = res["spans"] - res["skipped_silent"]
    check(res["spans"] == want and scored > 0 and len(table) == scored + 2,
          f"metrics.csv has {len(table)} rows for {res['spans']} of {want} spans "
          f"({res['skipped_silent']} skipped for a silent reference)")
    for row in table[-2:]:
        print(f"serving[remix eval] metrics.csv {row['snt_id']}: "
              + ", ".join(f"{k} {float(v):.4f}" for k, v in row.items() if k != "snt_id"),
              flush=True)
    n = res["mixtures"]
    print(f"serving[remix eval]: {n} mixtures x {t_mix / SR:g} s, {want} metadata spans "
          f"({sum(e - s for sp in segments.values() for s, e in sp) / SR:.1f} audio-s; "
          f"{scored} scored, {res['skipped_silent']} skipped for a silent reference), "
          f"moving_audio_1 and _3 (the eval dataset's default num_spks=(0, 2), read as "
          f"ids) + noise, SIR/SNR "
          f"from seed {cfg['seed']}: wall per mixture {wall / n:.4f} s = forward "
          f"{res['forward_s'] / n:.4f} s + tracker {res['metrics_s'] / n:.4f} s (SDRs on "
          f"{device.type}, STOI and PESQ on the host; PESQ host s per mixture: "
          + ", ".join(f"{k} {v / n:.4f}" for k, v in clocks.items())
          + f"); columns {list(table[0])}; backend {columns[next(iter(columns))].backend}",
          flush=True)

    # The first crop of a metadata span in which no reference is silent.
    crops = ((mix, targets, s)
             for mix, targets, folder in (ds[i] for i in range(len(ds)))
             for a, b in segments[folder] for s in range(a, b - t_crop + 1, t_crop)
             if np.abs(targets[:, s:s + t_crop]).max(axis=-1).min() >= 1e-6)
    found = next(crops, None)
    check(found is not None, "no crop of the split without a silent reference")
    mix, targets, s = found
    e = s + t_crop
    est = fwd32(torch.from_numpy(mix[None, s:e]).to(device))[0].cpu().numpy()
    rows = {}
    for side, dev in (("device", device), ("cpu", "cpu")):
        tracker = MetricsTracker(root / f"gate_{side}.csv", device=dev)
        tracker(mix[s:e], targets[:, s:e], est, "gate")
        check(len(tracker.rows) == 1, f"the tracker on the {side} dropped the segment")
        rows[side] = tracker.rows[0]
    d_si = abs(rows["device"]["si-snr"] - rows["cpu"]["si-snr"])
    d_sdr = abs(rows["device"]["sdr"] - rows["cpu"]["sdr"])
    check(d_si <= SISNR_DB and d_sdr <= SDR_DB,
          f"tracker on the device vs the CPU: si-snr {d_si} dB, sdr {d_sdr} dB")
    print(f"serving[tracker gate]: one {(e - s) / SR:g} s segment's estimate, the device vs "
          f"the CPU: |d si-snr| {d_si:.3g} dB (tol {SISNR_DB}), |d sdr| {d_sdr:.3g} dB "
          f"(tol {SDR_DB})", flush=True)


def _training_config(model_cfg, cfg, split: Path, val: Path, exp: Path) -> dict:
    """configs/separation/convtasnet.yaml as a dict (the card's host may
    have no pyyaml), over phase 8's split, cut to ``cfg``'s samples, batch
    and epochs."""
    def pit(sdr_type):
        return {"_target_": "sonicsim_tpu.losses.PITLossWrapper",
                "loss_func": {"_target_": "sonicsim_tpu.losses.PairwiseNegSDR",
                              "sdr_type": sdr_type},
                "pit_from": "pw_mtx", "threshold_byloss": False}

    return {
        "exp": {"dir": str(exp), "name": "Conv-TasNet"},
        "datas": {"_target_": "sonicsim_tpu.dataset.MovingDataModule", "train_dir": str(split),
                  "val_dir": str(val), "test_dir": str(val), "num_spks": 2, "sample_rate": SR,
                  "num_samples": cfg["fit_samples"], "duration": cfg["crop_s"],
                  "batch_size": cfg["fit_batch"], "is_mono": True, "noise_type": "noise",
                  "seed": cfg["seed"]},
        "model": {"_target_": "sonicsim_tpu.models.ConvTasNet", **model_cfg},
        "optimizer": {"lr": cfg["lr"], "weight_decay": 0.0},
        "scheduler": {"patience": 10, "factor": 0.5},
        "loss": pit("snr"),
        "metrics": pit("sisdr"),
        "early_stopping": {"patience": 20},
        "checkpoint": {"save_top_k": 5},
        "trainer": {"max_epochs": cfg["fit_epochs"], "gradient_clip_val": cfg["clip"]},
    }


def phase_training(device, cfg, model_cfg, folders, root: Path, smi) -> None:
    """Phase 10: ConvTasNet training on the device. The train step's time
    and peak extra memory in fp32 and bf16; one fp32 step against the CPU;
    bf16 against fp32 over a few steps; a short fit over phase 8's split
    through the train CLI's path, resumed for one more epoch, and its
    ``best_model.pkl`` read back by ``from_pretrain``."""
    import torch

    from sonicsim_tpu_torch import bridge
    from sonicsim_tpu_torch.dataset import MovingDataModule
    from sonicsim_tpu_torch.losses import PairwiseNegSDR, PITLossWrapper
    from sonicsim_tpu_torch.models import ConvTasNet, from_pretrain
    from sonicsim_tpu_torch.scripts import generate_fixed_eval
    from sonicsim_tpu_torch.scripts.train import train_from_config
    from sonicsim_tpu_torch.train import make_optimizer, make_train_step
    from sonicsim_tpu_torch.utils import wav_num_frames

    root.mkdir()
    split = folders[0].parent.parent
    weights = bridge.convtasnet_state_dict(seeded_convtasnet(model_cfg, cfg["seed"]))
    loss_fn = PITLossWrapper(PairwiseNegSDR("snr"), pit_from="pw_mtx", threshold_byloss=False)

    def fresh(dev, precision="f32"):
        model = ConvTasNet(**model_cfg, device=dev)
        model.load_state_dict(weights)
        opt = make_optimizer(model.parameters(), cfg["lr"])
        return model, make_train_step(model, loss_fn, opt, precision, clip_norm=cfg["clip"])

    t_crop = int(cfg["crop_s"] * SR)
    dm = MovingDataModule(train_dir=str(split), val_dir=str(split), test_dir=str(split),
                          duration=cfg["crop_s"], num_samples=cfg["batch"],
                          batch_size=cfg["batch"], seed=cfg["seed"])
    mix, tgt = next(iter(dm.train_batches(0)))
    x, y = torch.from_numpy(mix).to(device), torch.from_numpy(tgt).to(device)
    check(tuple(y.shape) == (cfg["batch"], 2, t_crop), f"train batch {tuple(y.shape)}")
    audio_s = cfg["batch"] * cfg["crop_s"]
    stats = {}
    for precision in ("f32", "bf16"):
        _, step = fresh(device, precision)
        check(bool(torch.isfinite(step(x, y))), f"{precision} step: loss not finite")
        ms = median_ms(lambda step=step: step(x, y), device, reps=cfg["reps"],
                       warmup=cfg["warmup"])
        stats[precision] = (ms, audio_s / (ms / 1e3), _peak_mib(device, lambda step=step: step(x, y)))

    # One fp32 step, the device against the CPU, from the same weights and
    # batch. Parameters after it are not compared: at step 1 Adam moves each
    # by lr·g/(|g| + eps), so a near-zero gradient whose sign differs between
    # the two sides moves its parameter by up to 2·lr.
    n_chk = int(cfg["check_s"] * SR)
    xc, yc = (torch.from_numpy(a[:cfg["check_batch"], ..., :n_chk].copy()) for a in (mix, tgt))
    sides = {}
    for side, dev in (("device", device), ("cpu", torch.device("cpu"))):
        model, step = fresh(dev)
        t0 = time.perf_counter()
        loss = float(step(xc.to(dev), yc.to(dev)))
        sides[side] = (loss, {n: p.grad.cpu() for n, p in model.named_parameters()},
                       time.perf_counter() - t0)
    (l_dev, g_dev, _), (l_cpu, g_cpu, cpu_s) = sides["device"], sides["cpu"]
    g_max = max(float(g.abs().max()) for g in g_cpu.values())
    g_err = max(float((g_dev[n] - g).abs().max()) for n, g in g_cpu.items())
    l_rel = abs(l_dev - l_cpu) / abs(l_cpu)
    check(l_rel <= TRAIN_LOSS_REL and g_err <= TRAIN_GRAD_REL * g_max,
          f"fp32 step on the device vs the CPU: loss {l_dev} vs {l_cpu} (rel {l_rel}), "
          f"gradients max abs err {g_err} of max|g| {g_max}")

    # bf16 against fp32: the same weights, a few steps each on one batch.
    traces = {}
    for precision in ("f32", "bf16"):
        model, step = fresh(device, precision)
        traces[precision] = [float(step(x, y)) for _ in range(cfg["bf16_steps"])]
        check(all(p.dtype == torch.float32 for p in model.parameters()),
              f"{precision}: master weights are not float32")
    f32, bf16 = traces["f32"], traces["bf16"]
    check(all(np.isfinite(t).all() and t[-1] < t[0] for t in (f32, bf16)),
          f"the loss did not fall: fp32 {f32}, bf16 {bf16}")
    check(abs(bf16[0] - f32[0]) < 0.1 * abs(f32[0]) + 0.5,
          f"first bf16 loss {bf16[0]} vs fp32 {f32[0]} (tests/test_train.py's bound)")
    print(f"training: ConvTasNet N={model_cfg['N']} X={model_cfg['X']} R={model_cfg['R']}, "
          f"Adam lr {cfg['lr']}, optax clip {cfg['clip']}, PIT neg-SNR, B={cfg['batch']} x "
          f"{cfg['crop_s']:g} s from phase 8's split: "
          + " | ".join(f"{k}: {v[0]:.4f} ms/step = {v[1]:.1f} audio-s/s, peak extra memory "
                       f"{v[2] if v[2] is None else round(v[2], 1)} MiB" for k, v in stats.items())
          + f" (CUDA-event median of {cfg['reps']} after {cfg['warmup']}); fp32 step on "
          f"B={cfg['check_batch']} x {cfg['check_s']:g} s vs the CPU ({cpu_s:.3f} s there): "
          f"loss rel {l_rel:.3g} (tol {TRAIN_LOSS_REL}), gradients max abs err {g_err:.3g} of "
          f"max|g| {g_max:.3g} (tol {TRAIN_GRAD_REL}·max|g|); {cfg['bf16_steps']} steps fp32 "
          f"{[round(v, 4) for v in f32]}, bf16 {[round(v, 4) for v in bf16]}; {smi}", flush=True)

    # A short fit over phase 8's split: val on its fixed remix
    # (scripts.generate_fixed_eval), then one more epoch from the resume point.
    val = generate_fixed_eval.main(["--in_dir", str(split), "--out_dir", str(root / "val"),
                                    "--seed", str(cfg["seed"]), "--device", str(device)])
    conf = _training_config(model_cfg, cfg, split, val, root / "exp")
    exp = root / "exp" / "Conv-TasNet"
    train_from_config(conf, device)
    records = [json.loads(ln) for ln in (exp / "metrics.jsonl").read_text().splitlines()]
    want = list(range(-1, cfg["fit_epochs"]))
    check([r["epoch"] for r in records] == want, f"metrics.jsonl epochs {records}")
    check(all(np.isfinite(r["val_loss"]) for r in records), f"val losses {records}")
    check({"meta.json", "state.pt"} <= {p.name for p in (exp / "checkpoints" / "last").iterdir()},
          "no resume point")
    resumed = train_from_config(conf, device, max_epochs=cfg["fit_epochs"] + 1, resume=True)
    after = [json.loads(ln) for ln in (exp / "metrics.jsonl").read_text().splitlines()]
    check([r["epoch"] for r in after] == want + [cfg["fit_epochs"]]
          and [r["epoch"] for r in resumed.history] == want + [cfg["fit_epochs"]],
          f"the resumed fit did not pick up at epoch {cfg['fit_epochs']}: {after}")
    top = json.loads((exp / "best_k_models.json").read_text())
    best = min(top, key=top.get)
    check((exp / "best_model.pkl").read_bytes() == Path(best).read_bytes(),
          "best_model.pkl is not the best top-k checkpoint")
    last = [p for p in top if Path(p).name.startswith(f"epoch={cfg['fit_epochs']}-")]
    check(len(last) == 1, f"the last epoch's checkpoint is not in the top-k: {top}")
    # The pack of the epoch whose weights the trainer holds, read back on the
    # device, against the trainer's model: bit-equal; and best_model.pkl
    # against it where the last epoch is the best.
    xv = x[:2]
    with torch.inference_mode():
        want_out = resumed.model.eval()(xv)
        packs = {"last epoch": last[0]} | ({"best_model.pkl": str(exp / "best_model.pkl")}
                                           if best == last[0] else {})
        for name, path in packs.items():
            check(torch.equal(from_pretrain(path, device=device)(xv), want_out),
                  f"from_pretrain({name}) is not bit-equal to the trained model")
    val_s = [wav_num_frames(d / "mix.wav") / SR for d in sorted(val.iterdir())]
    print(f"training[fit]: {cfg['fit_samples']} samples x {cfg['crop_s']:g} s per epoch, batch "
          f"{cfg['fit_batch']}, val on the split's fixed remix ({len(val_s)} x {max(val_s):g} s, "
          f"{cfg['crop_s']:g} s crops), TF32 off: s/epoch "
          f"{[round(r['seconds'], 3) for r in after]} (epochs {[r['epoch'] for r in after]}, -1 the "
          f"baseline val, {cfg['fit_epochs']} resumed), train loss "
          f"{[round(r['train_loss'], 4) for r in after if 'train_loss' in r]}, val neg-SI-SDR "
          f"{[round(r['val_loss'], 4) for r in after]}; metrics.jsonl, top-k ({len(top)}), "
          f"best_model.pkl = {Path(best).name}; the resume picked up at epoch "
          f"{cfg['fit_epochs']}; from_pretrain bit-equal to the trained model for "
          f"{list(packs)}", flush=True)


def _mono_mixes(folders) -> list:
    """Each generated mixture's five tracks summed (binaural), and mono."""
    from sonicsim_tpu_torch.utils import read_wav

    return [np.sum([read_wav(f / n)[0] for n in sorted(p.name for p in f.glob("*_audio*.wav"))],
                   axis=0, dtype=np.float32).mean(axis=0) for f in folders]


def phase_zoo(device, cfg, folders, root: Path, smi) -> dict:
    """Phase 11: each zoo model from a pack on the device; its fp32 forward
    against the port on the CPU on a crop of phase 8's first mixture, its
    10 s forward's time and peak extra memory, the inference CLI on that
    60 s mixture. Returns each model's numbers (training: phase 15)."""
    import torch

    from sonicsim_tpu_torch.models import from_pretrain, save_model
    from sonicsim_tpu_torch.scripts import inference
    from sonicsim_tpu_torch.scripts.common import make_forward, strict_float32
    from sonicsim_tpu_torch.utils import read_wav, write_wav

    strict_float32()
    root.mkdir()
    mono = _mono_mixes(folders)
    mix_path = root / "mix.wav"
    write_wav(mix_path, mono[0][None], SR, encoding="float32")
    t_mix, t_win = mono[0].shape[-1], int(cfg["window_s"] * SR)
    x10 = torch.from_numpy(mono[0][None, :t_win].copy()).to(device)
    stats = {}
    for name, args in cfg["models"].items():
        t0 = time.perf_counter()
        cpu = seeded_zoo(name, args, cfg["seed"])
        pack = root / f"{name}.pkl"
        save_model(cpu, pack)
        model = from_pretrain(pack, device=device)
        check(type(model).__name__ == name, f"{name}: from_pretrain built {type(model).__name__}")
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        fwd = make_forward(model)
        crop_s = cfg["crop_s"]
        crop = torch.from_numpy(mono[0][None, :int(crop_s * SR)].copy())
        t0 = time.perf_counter()
        with torch.inference_mode():
            ref = cpu(crop)
        cpu_s = time.perf_counter() - t0
        got = fwd(crop.to(device)).cpu()
        err, peak = float((got - ref).abs().max()), float(ref.abs().max())
        check(tuple(got.shape) == (1, 2, crop.shape[-1]) and bool(torch.isfinite(got).all()),
              f"{name}: output {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
        check(err <= ZOO_REL * peak,
              f"{name} on the device vs the CPU: max abs err {err} (max|ref| {peak})")
        ms = median_ms(lambda fwd=fwd: fwd(x10), device, reps=cfg["reps"], warmup=cfg["warmup"])
        mib = _peak_mib(device, lambda fwd=fwd: fwd(x10))
        argv = ["--model_path", str(pack), "--mix", str(mix_path), "--out_dir",
                str(root / f"sep_{name}"), "--segment_seconds", str(cfg["segment_s"]),
                "--device", str(device)]
        t0 = time.perf_counter()
        inference.main(argv)
        cli_s = time.perf_counter() - t0
        for i in range(2):
            est, _ = read_wav(root / f"sep_{name}" / f"s{i + 1}_est.wav")
            check(est.shape == (1, t_mix) and bool(np.isfinite(est).all()),
                  f"{name} inference: s{i + 1}_est.wav {est.shape}")
        b16 = serve_bf16(device, name, cpu, model, crop, got, x10, cfg)
        if name == cfg["bf16_cli"]:
            b16["cli"] = bf16_cli_check(device, name, pack, mix_path, root / f"cli_{name}", 2,
                                        cfg["segment_s"])
        stats[name] = dict(params=n_params, crop_s=crop_s, err=err, max_ref=peak, cpu_s=cpu_s,
                           ms=ms, audio_s_per_s=cfg["window_s"] / (ms / 1e3), peak_mib=mib,
                           cli_s=cli_s, build_s=build_s, bf16=b16)
        print(f"zoo[{name}]: {n_params} parameters, seeded, from {pack.name} via "
              f"from_pretrain ({build_s:.2f} s with the build on the CPU); fp32 vs the port on "
              f"the CPU on a {crop_s:g} s crop of phase 8's first mixture ({cpu_s:.2f} s there): "
              f"max abs err {err:.3g} of max|ref| {peak:.3g} (tol {ZOO_REL}·max|ref|); "
              f"B=1 x {cfg['window_s']:g} s: {ms:.4f} ms = "
              f"{stats[name]['audio_s_per_s']:.1f} audio-s/s (CUDA-event median of "
              f"{cfg['reps']} after {cfg['warmup']}), peak extra memory "
              f"{mib if mib is None else round(mib, 1)} MiB; inference CLI on the "
              f"{t_mix / SR:g} s mixture ({cfg['segment_s']:g} s windows, load and WAV I/O "
              f"included, no warm-up of its own): {cli_s:.4f} s; {bf16_line(b16, cfg)}"
              + (f"; {b16['cli']}" if "cli" in b16 else "") + f"; {smi}", flush=True)
        del model, fwd, cpu
        if device.type == "cuda":
            torch.cuda.empty_cache()

    return stats


def _stream_run(streamer, x, depth: int, flush):
    """Stream (B, n) ``x`` in the streamer's chunks and a flush chunk at
    ``depth``: each chunk's output, its latency in ms (from the chunk's
    feed to its output's yield), and the wall seconds."""
    chunk = streamer.chunk_samples
    chunks = [x[:, s:s + chunk] for s in range(0, x.shape[1], chunk)] + [flush]
    streamer.reset(x.shape[0])
    fed, outs, got = [], [], []

    def feeder():
        for c in chunks:
            fed.append(time.perf_counter())
            yield c

    t0 = time.perf_counter()
    for out in streamer.stream(feeder(), depth=depth):
        got.append(time.perf_counter())
        outs.append(out)
    wall = time.perf_counter() - t0
    return outs, (np.asarray(got) - np.asarray(fed)) * 1e3, wall


def phase_streaming(device, cfg, folders, root: Path, smi) -> dict:
    """Phase 12: a causal SkiM at skim.yaml's widths from a pack on the card,
    streamed through ``SkiMStreamer`` over 10 s of phase 8's first mixture
    at each depth and over ``batch`` mixtures at once: per-chunk latency
    (median, p95) and the real-time factor; the stream against the offline
    causal forward on the card, ``stream(depth)`` against ``step``; then
    ``python -m sonicsim_tpu_torch.scripts.stream`` on the pack."""
    import torch

    from sonicsim_tpu_torch.models import SkiMStreamer, from_pretrain, save_model
    from sonicsim_tpu_torch.scripts.common import strict_float32
    from sonicsim_tpu_torch.utils import write_wav

    strict_float32()
    root.mkdir()
    mono = _mono_mixes(folders)
    n = int(cfg["seconds"] * SR)
    cpu = seeded_zoo("SkiMNet", cfg["model"], cfg["seed"])
    pack = root / "skim_causal.pkl"
    save_model(cpu, pack)
    model = from_pretrain(pack, device=device)
    streamer = SkiMStreamer(model)
    chunk, hop = streamer.chunk_samples, streamer.hop
    flush = torch.zeros(1, cfg["model"]["kernel_size"] - hop, device=device)
    x1 = torch.from_numpy(mono[0][None, :n].copy()).to(device)
    xb = torch.from_numpy(np.stack([mono[k % len(mono)][:n] for k in range(cfg["batch"])])
                          ).to(device)
    # Warm-up as the CLI does: two chunks reach the segment path, then the flush.
    for w in (chunk, chunk, flush.shape[1]):
        streamer.step(torch.zeros(1, w, device=device))

    streamer.reset()
    steps = [streamer.step(x1[:, s:s + chunk]).cpu().numpy() for s in range(0, n, chunk)]
    steps.append(streamer.step(flush).cpu().numpy())
    with torch.inference_mode():
        offline1, offline_b = model(x1).cpu().numpy(), model(xb).cpu().numpy()
    runs, stats = {}, {}
    for depth in cfg["depths"]:
        runs[f"B=1 depth {depth}"] = (_stream_run(streamer, x1, depth, flush), offline1)
    runs[f"B={cfg['batch']} depth {cfg['batch_depth']}"] = (
        _stream_run(streamer, xb, cfg["batch_depth"], flush.expand(cfg["batch"], -1)), offline_b)
    for label, ((outs, lat, wall), offline) in runs.items():
        streamed = np.concatenate(outs, axis=-1)
        m = min(streamed.shape[-1], offline.shape[-1]) - hop
        err = np.abs(streamed[..., :m] - offline[..., :m])
        tol = STREAM_ATOL + STREAM_RTOL * np.abs(offline[..., :m])
        check(bool(np.isfinite(streamed).all()) and m >= n - hop and bool((err <= tol).all()),
              f"SkiM stream {label} vs the offline causal forward: max abs err "
              f"{float(err.max())}, worst err/tol {float((err / tol).max())}, {m} samples")
        stats[label] = dict(p50_ms=float(np.median(lat)), p95_ms=float(np.percentile(lat, 95)),
                            rtf=cfg["seconds"] / wall, wall_s=wall, err=float(err.max()))
        if label.startswith("B=1"):
            check(len(outs) == len(steps), f"{label}: {len(outs)} outputs, {len(steps)} steps")
            d = max(float(np.abs(a - b).max(initial=0.0)) for a, b in zip(outs, steps))
            check(d <= STREAM_STEP_ATOL, f"SkiM stream {label} vs step(): max abs diff {d}")
            stats[label]["vs_step"] = d

    mix_path = root / "mix.wav"
    write_wav(mix_path, mono[0][None, :n], SR, encoding="float32")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "sonicsim_tpu_torch.scripts.stream", "--model_path",
                        str(pack), "--mix", str(mix_path), "--out_dir", str(root / "cli"),
                        "--device", str(device)], cwd=str(Path(__file__).resolve().parent),
                       capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    check(r.returncode == 0, f"scripts.stream exited {r.returncode}: {r.stderr[-2000:]}")
    cli = json.loads(r.stdout.strip().splitlines()[-1])
    check(all(Path(o).is_file() for o in cli["outputs"]) and len(cli["outputs"]) == 2,
          f"scripts.stream outputs: {cli['outputs']}")
    print(f"stream[SkiM causal, skim.yaml's widths, from {pack.name} via from_pretrain]: "
          f"chunk {chunk} samples = {1e3 * chunk / SR:g} ms, {cfg['seconds']:g} s of phase 8's "
          f"mixture(s) | " + " | ".join(
              f"{k}: per-chunk latency p50 {v['p50_ms']:.4f} ms, p95 {v['p95_ms']:.4f} ms, "
              f"real-time factor {v['rtf']:.2f} (wall {v['wall_s']:.4f} s), vs offline max abs "
              f"err {v['err']:.3g}" + (f", vs step() {v['vs_step']:.3g}" if "vs_step" in v else "")
              for k, v in stats.items())
          + f" (tol rtol {STREAM_RTOL} / atol {STREAM_ATOL}; step {STREAM_STEP_ATOL}); "
          f"scripts.stream CLI: {json.dumps(cli['chunk_latency_ms'])} ms, real-time factor "
          f"{cli['real_time_factor']}, process wall {cli_s:.2f} s; {smi}", flush=True)
    return stats


def phase_enhancement(device, cfg, folders, root: Path, smi) -> dict:
    """Phase 13: each enhancement config's model from a pack on the card: its
    fp32 forward and ``to_waveform`` against the port on the CPU on a crop
    of phase 8's first mixture, its 10 s forward's time and peak extra
    memory; then ``cfg["eval_model"]`` through the remix evaluation
    (``scripts.audio_test``'s loop, task enhancement) over phase 8's split.
    Returns each model's numbers."""
    import csv

    import torch

    from sonicsim_tpu_torch.models import from_pretrain, save_model
    from sonicsim_tpu_torch.scripts import audio_test
    from sonicsim_tpu_torch.scripts.common import make_forward, pesq_columns, strict_float32
    from sonicsim_tpu_torch.utils import write_wav

    strict_float32()
    root.mkdir()
    mono = _mono_mixes(folders)
    mix_path = root / "mix.wav"
    write_wav(mix_path, mono[0][None], SR, encoding="float32")
    t_win = int(cfg["window_s"] * SR)
    x10 = torch.from_numpy(mono[0][None, :t_win].copy()).to(device)
    crop = torch.from_numpy(mono[0][None, :int(cfg["crop_s"] * SR)].copy())
    print(f"enh[torch.fft.rfft by dtype on {device}]: {fft_dtypes(device)}", flush=True)
    stats, served = {}, {}
    for stem, (name, args) in cfg["models"].items():
        t0 = time.perf_counter()
        cpu = seeded_zoo(name, args, cfg["seed"])
        pack = root / f"{stem}.pkl"
        save_model(cpu, pack)
        model = from_pretrain(pack, device=device)
        check(type(model).__name__ == name, f"{stem}: from_pretrain built {type(model).__name__}")
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        fwd = make_forward(model)
        t0 = time.perf_counter()
        ref = make_forward(cpu)(crop)
        cpu_s = time.perf_counter() - t0
        got = fwd(crop.to(device)).cpu()
        err, peak = float((got - ref).abs().max()), float(ref.abs().max())
        check(tuple(got.shape) == (1, 1, crop.shape[-1]) and bool(torch.isfinite(got).all()),
              f"{stem}: output {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
        check(err <= ZOO_REL * peak,
              f"{stem} on the device vs the CPU: max abs err {err} (max|ref| {peak})")
        ms = median_ms(lambda fwd=fwd: fwd(x10), device, reps=cfg["reps"], warmup=cfg["warmup"])
        mib = _peak_mib(device, lambda fwd=fwd: fwd(x10))
        b16 = serve_bf16(device, name, cpu, model, crop, got, x10, cfg)
        if stem == cfg["bf16_cli"]:
            b16["cli"] = bf16_cli_check(device, stem, pack, mix_path, root / f"cli_{stem}", 1,
                                        cfg["segment_s"])
        stats[stem] = dict(model=name, params=n_params, err=err, max_ref=peak, cpu_s=cpu_s, ms=ms,
                           audio_s_per_s=cfg["window_s"] / (ms / 1e3), peak_mib=mib, bf16=b16)
        print(f"enh[{stem}: {name}]: {n_params} parameters, seeded, from {pack.name} via "
              f"from_pretrain ({build_s:.2f} s with the build on the CPU); fp32 forward and "
              f"to_waveform vs the port on the CPU on a {cfg['crop_s']:g} s crop of phase 8's "
              f"first mixture ({cpu_s:.2f} s there): max abs err {err:.3g} of max|ref| "
              f"{peak:.3g} (tol {ZOO_REL}·max|ref|); B=1 x {cfg['window_s']:g} s: {ms:.4f} ms = "
              f"{stats[stem]['audio_s_per_s']:.1f} audio-s/s (CUDA-event median of "
              f"{cfg['reps']} after {cfg['warmup']}), peak extra memory "
              f"{mib if mib is None else round(mib, 1)} MiB; {bf16_line(b16, cfg)}"
              + (f"; {b16['cli']}" if "cli" in b16 else "") + f"; {smi}", flush=True)
        if stem == cfg["eval_model"]:
            served = dict(model=model, stem=stem)
        else:
            del model
        del fwd
        if device.type == "cuda":
            torch.cuda.empty_cache()

    split = folders[0].parent.parent
    t0 = time.perf_counter()
    res = audio_test.evaluate_remix(served["model"], split,
                                    root / "results" / "metrics_remix-noise.csv",
                                    task="enhancement", extra_metrics=pesq_columns(),
                                    seed=cfg["seed"])
    wall = time.perf_counter() - t0
    with open(res["csv"]) as f:
        table = list(csv.DictReader(f))
    scored = res["spans"] - res["skipped_silent"]
    check(res["mixtures"] == len(folders) and scored > 0 and len(table) == scored + 2,
          f"enhancement metrics.csv has {len(table)} rows for {res['spans']} spans")
    n = res["mixtures"]
    print(f"enh[remix eval, {served['stem']}]: {n} mixtures x "
          f"{len(_mono_mixes(folders[:1])[0]) / SR:g} s, moving_audio_1 + noise at an SNR "
          f"from seed {cfg['seed']} (task enhancement): wall per mixture {wall / n:.4f} s = "
          f"forward {res['forward_s'] / n:.4f} s + tracker {res['metrics_s'] / n:.4f} s; "
          + "; ".join(f"metrics.csv {row['snt_id']}: " + ", ".join(
              f"{k} {float(v):.4f}" for k, v in row.items() if k != "snt_id")
              for row in table[-2:]), flush=True)
    stats["eval"] = dict(model=served["stem"], wall_per_mixture_s=wall / n)
    return stats


def _flat_leaves(tree: dict, prefix: str = "") -> list:
    """A pack's flax tree as sorted (path, array) pairs."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _flat_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k,
                                                                               np.asarray(v))]
    return out


def _instantiate_loss(node):
    """A loss or metric node of ENH_LOSSES, ``(class name, arguments)``,
    built through its config ``_target_`` (read as the port's)."""
    from sonicsim_tpu_torch.utils import instantiate

    name, args = node
    return instantiate({"_target_": f"sonicsim_tpu.losses.{name}", **args})


def _enh_fit_config(cfg, name: str, args: dict, split: Path, val: Path, exp: Path) -> dict:
    """configs/enhancement/<fit_model>.yaml as a dict (the card's host may
    have no pyyaml), over phase 8's split, cut to ``cfg``'s samples and
    epochs; the val set's targets are ``clean.wav`` (ROADMAP C13)."""
    loss, metric = cfg["losses"][cfg["fit_model"]]
    return {
        "exp": {"dir": str(exp), "name": name},
        "datas": {"_target_": "sonicsim_tpu.dataset.MovingDataModule", "train_dir": str(split),
                  "val_dir": str(val), "test_dir": str(val), "num_spks": 1, "sample_rate": SR,
                  "num_samples": cfg["fit_samples"], "duration": cfg["crop_s"],
                  "batch_size": cfg["batch"], "is_mono": True, "noise_type": "noise",
                  "seed": cfg["seed"], "target_names": ["clean"]},
        "model": {"_target_": f"sonicsim_tpu.models.{name}", **args},
        "loss": {"_target_": f"sonicsim_tpu.losses.{loss[0]}", **loss[1]},
        "metrics": {"_target_": f"sonicsim_tpu.losses.{metric[0]}", **metric[1]},
        "optimizer": {"lr": cfg["lr"], "weight_decay": 0.0},
        "scheduler": {"patience": 5, "factor": 0.5},
        "early_stopping": {"patience": 20},
        "checkpoint": {"save_top_k": 5},
        "trainer": {"max_epochs": cfg["fit_epochs"], "gradient_clip_val": cfg["clip"]},
    }


# An ill-conditioned model's bound, in units of the CPU's float32 distance
# from float64: a device whose own float32 error is no larger than the
# CPU's lies within twice that of the CPU (the triangle inequality).
ILL_FACTOR = 2
# The same step in float64 on the device against float64 on the CPU, of
# max|g64|. The worst CPU float32 distance from float64 in the zoo,
# MossFormer's ~2.9e-4, is ~5e3 · 2^-24; the same amplification of float64
# rounding is ~5e3 · 2^-53 ≈ 6e-13, so 1e-9 leaves three orders of headroom
# and still fails any operation that computes another function.
F64_REL = 1e-9
KINK_REL = ZOO_REL  # of max|x|: how near 0 an input the two sides may send apart lies


def _kink_tape(model, tape: list, flips: dict | None):
    """Record or replay, through ``model``'s forward, the branch each kinked
    activation takes: every ``relu`` (``nn.ReLU``, ``torch.relu``,
    ``F.relu``, ``Tensor.relu``), every ``prelu`` (``nn.PReLU``), and every
    comparison of a float tensor with 0 (``x >= 0``, ``x > 0``: the GaGNet
    family's ``ChannelPReLU``, TF-GridNet's per-head PReLU), however the
    model calls them (a ``TorchFunctionMode`` held for the forward). With
    ``flips`` None they record, in call order and on the host, the side of 0
    each element of the input takes by its own rule; else each call replays
    the tape's side (``where(side, x, slope · x)``, or the recorded mask) and
    ``flips`` counts the elements whose own side differs, with the largest
    such |x| as a share of max|x| of the call.

    A pre-activation within rounding of 0 takes either branch, and the
    gradient that flows back through it changes by a whole term: in the
    GaGNet family the float32 and float64 steps part by about 1e-2·max|g|
    for that alone. Replayed, every side evaluates the branch the device
    took.

    Returns a second mode, for the caller to hold around the loss (the
    whole step): it records or replays the candidates at which a loss's
    ``amin`` / ``argmin`` over a dimension takes its minimum (PIT's
    permutation). Candidates within rounding of each other (estimates
    alike across sources) are the same kind of branch; a replayed ``amin``
    is the mean over the recorded minima, as ``amin`` splits its gradient
    over ties, and ``flips`` counts the rows sent apart with the recorded
    minimum's distance above the row's own as a share of max|x|."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    relus = {torch.relu, F.relu, torch.Tensor.relu}
    compares = {torch.Tensor.__ge__: torch.ge, torch.ge: torch.ge, torch.Tensor.ge: torch.ge,
                torch.Tensor.__gt__: torch.gt, torch.gt: torch.gt, torch.Tensor.gt: torch.gt}
    calls = iter(tape)

    def side_of(x, own):
        """The recorded side (recording it first), and the flips."""
        if flips is None:
            tape.append(own.cpu())
            return own
        side = next(calls).to(own.device)
        apart = side != own
        if bool(apart.any()):
            xd = x.detach()
            flips["n"] += int(apart.sum())
            flips["rel"] = max(flips["rel"], float(xd[apart].abs().max() / xd.abs().max()))
        return side

    class Kinks(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            x = args[0] if args else None
            if func in relus:
                if kwargs.get("inplace") or (len(args) > 1 and args[1] is True):
                    raise NotImplementedError("an in-place relu in a checked model")
                return torch.where(side_of(x, x.detach() > 0), x, torch.zeros_like(x))
            if func is F.prelu:
                w = args[1] if len(args) > 1 else kwargs["weight"]
                w = w.reshape((-1,) + (1,) * (x.dim() - 2)) if w.numel() > 1 else w
                return torch.where(side_of(x, x.detach() > 0), x, w * x)
            if (func in compares and isinstance(x, torch.Tensor) and x.is_floating_point()
                    and len(args) > 1 and not isinstance(args[1], torch.Tensor)
                    and args[1] == 0):
                return side_of(x, compares[func](x.detach(), 0))
            return func(*args, **kwargs)

    mode = Kinks()

    def enter(mod, args):
        mode.__enter__()

    def leave(mod, args, out):
        mode.__exit__(None, None, None)

    model.register_forward_pre_hook(enter)
    model.register_forward_hook(leave)

    mins = {torch.amin: "amin", torch.Tensor.amin: "amin",
            torch.argmin: "argmin", torch.Tensor.argmin: "argmin"}

    class Choices(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            x = args[0] if args else None
            dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
            if (func not in mins or not isinstance(x, torch.Tensor) or not x.is_floating_point()
                    or not isinstance(dim, int) or kwargs.get("keepdim") or len(args) > 2):
                return func(*args, **kwargs)
            xd = x.detach()
            low = xd.amin(dim, keepdim=True)
            own = xd == low
            if flips is None:
                tape.append(own.cpu())
                return func(*args, **kwargs)
            side = next(calls).to(own.device)
            apart = (side != own).any(dim)
            if bool(apart.any()):
                picked = (xd * side).sum(dim, keepdim=True) / side.sum(dim, keepdim=True)
                flips["n"] += int(apart.sum())
                flips["rel"] = max(flips["rel"],
                                   float((picked - low).abs().max() / xd.abs().max()))
            if mins[func] == "argmin":
                return side.to(torch.uint8).argmax(dim)  # the first recorded minimum
            w = side.to(x.dtype)
            return (x * w).sum(dim) / w.sum(dim)

    return Choices()


def enh_step_check(fresh, xb, yb, device) -> dict:
    """One float32 train step from the same weights on ``device`` and on the
    CPU, and the float64 step on the CPU and on ``device`` (``fresh(dev)``
    builds the model and its step there): the loss's relative distance,
    the clipped gradients' largest distance (and where), each side's
    distance from the CPU's float64 as a share of max|g64|, and the bound
    the device's float32 gradients are held to. Every side after the
    device's float32 one replays its branch at each kinked activation and
    the loss's choice of minimum (``_kink_tape``); an element sent apart
    must lie within ``KINK_REL`` · max|x| of 0, a minimum within
    ``KINK_REL`` · max|x| of the row's own.

    The float64 step on the device must lie within ``F64_REL`` · max|g64|
    of the CPU's (``device_f64_err``): at float64 the comparison has power
    at any conditioning, and tells a device that computes another function
    from one that rounds worse. The CPU's float32 distance ``cpu_vs_f64``
    is the larger distance from float64 of two CPU summation orders (its
    default thread count and two threads); the float32 bound is
    ``max(TRAIN_GRAD_REL, ILL_FACTOR · cpu_vs_f64) · max|g|``, the
    triangle inequality's bound for a device that rounds no worse than the
    CPU, never below phase 10's ``TRAIN_GRAD_REL``."""
    import torch

    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    tape: list = []
    flips = dict(n=0, rel=0.0)
    sides = {}
    plan = [("device", device, torch.float32, threads),
            ("cpu", cpu, torch.float32, threads),
            ("cpu2", cpu, torch.float32, 2),
            ("f64", cpu, torch.float64, threads),
            ("device_f64", device, torch.float64, threads)]
    for side, dev, dtype, n in plan:
        torch.set_num_threads(n)
        try:
            model, step = fresh(dev)
            model.to(dtype)
            choices = _kink_tape(model, tape, None if side == "device" else flips)
            t0 = time.perf_counter()
            with choices:
                loss = float(step(xb.to(dev, dtype), yb.to(dev, dtype)))
            elapsed = time.perf_counter() - t0
        finally:
            torch.set_num_threads(threads)
        sides[side] = (loss, {n_: p.grad.double().cpu() for n_, p in model.named_parameters()
                              if p.grad is not None}, elapsed)
        del model, step
    (l_dev, g_dev, _), (l_cpu, g_cpu, cpu_s) = sides["device"], sides["cpu"]
    g64 = sides["f64"][1]
    g_max = max(float(g.abs().max()) for g in g_cpu.values())
    top64 = max(float(g.abs().max()) for g in g64.values())

    def dist(a, b):
        worst = max(b, key=lambda n: float((a[n] - b[n]).abs().max()))
        return float((a[worst] - b[worst]).abs().max()), worst

    g_err, worst = dist(g_dev, g_cpu)
    cpu_vs_f64 = max(dist(sides[k][1], g64)[0] for k in ("cpu", "cpu2")) / top64
    ill = ILL_FACTOR * cpu_vs_f64 > TRAIN_GRAD_REL
    f64_err, f64_worst = dist(sides["device_f64"][1], g64)
    return dict(loss=(l_dev, l_cpu), loss_rel=abs(l_dev - l_cpu) / abs(l_cpu), grad_err=g_err,
                worst=worst, grad_max=g_max, cpu_vs_f64=cpu_vs_f64,
                cpu_vs_cpu2=dist(g_cpu, sides["cpu2"][1])[0] / g_max,
                device_vs_f64=dist(g_dev, g64)[0] / top64,
                bound=(ILL_FACTOR * cpu_vs_f64 if ill else TRAIN_GRAD_REL) * g_max, ill=ill,
                device_f64_err=f64_err / top64, device_f64_worst=f64_worst,
                device_f64_s=sides["device_f64"][2],
                kinks=len(tape), flips=flips["n"], flip_rel=flips["rel"], cpu_s=cpu_s,
                params=sum(g.numel() for g in g_cpu.values()))


def _loudest_window(mix, tgt, batch: int, n: int):
    """The first ``batch`` items' ``n``-sample window where the quietest
    target track is loudest, as CPU tensors: a silent target makes an
    SNR-type loss, and its gradient, ill-posed."""
    import torch

    t = tgt.shape[-1]
    sq = np.square(tgt[:batch].reshape(-1, t).astype(np.float64))
    energy = np.cumsum(np.concatenate([np.zeros((sq.shape[0], 1)), sq], axis=1), axis=1)
    start = int(np.argmax((energy[:, n:] - energy[:, :-n]).min(axis=0)))
    return tuple(torch.from_numpy(a[:batch, ..., start:start + n].copy()) for a in (mix, tgt))


def phase_enh_training(device, cfg, models, folders, root: Path, smi) -> dict:
    """Phase 14: each enhancement config's model trained in float32 with
    its config's loss, Adam and clip, from phase 13's seeded weights: the
    step's time and peak extra memory at the configs' batch and duration on
    phase 8's split, the metric on that batch, and one step on the device
    against the same step on the CPU (loss and clipped gradients); then a
    2 + 1 epoch ``train_from_config`` fit of ``cfg["fit_model"]`` over the
    split with a ``generate_fixed_eval --task enhancement`` val set, its
    best checkpoint read back by ``from_pretrain``. Returns each model's
    numbers."""
    import torch

    from sonicsim_tpu_torch.dataset import MovingDataModule
    from sonicsim_tpu_torch.models import from_pretrain, get, serialize
    from sonicsim_tpu_torch.scripts import generate_fixed_eval
    from sonicsim_tpu_torch.scripts.common import strict_float32
    from sonicsim_tpu_torch.scripts.train import train_from_config
    from sonicsim_tpu_torch.train import make_optimizer, make_train_step

    strict_float32()
    root.mkdir()
    split = folders[0].parent.parent
    dm = MovingDataModule(train_dir=str(split), val_dir=str(split), test_dir=str(split),
                          num_spks=1, duration=cfg["crop_s"], num_samples=cfg["batch"],
                          batch_size=cfg["batch"], seed=cfg["seed"])
    mix, tgt = next(iter(dm.train_batches(0)))
    t_crop = int(cfg["crop_s"] * SR)
    check(tuple(tgt.shape) == (cfg["batch"], t_crop), f"enhancement batch {tuple(tgt.shape)}")
    x, y = torch.from_numpy(mix).to(device), torch.from_numpy(tgt).to(device)
    # The check window: the one where the quietest item's target is loudest
    # (the GaGNet family's losses RMS-normalise the target).
    xc, yc = _loudest_window(mix, tgt, cfg["check_batch"], int(cfg["check_s"] * SR))
    audio_s = cfg["batch"] * cfg["crop_s"]
    stats = {}
    for stem, (name, args) in models.items():
        loss_node, metric_node = cfg["losses"][stem]
        loss_fn, metric_fn = _instantiate_loss(loss_node), _instantiate_loss(metric_node)
        weights = seeded_zoo(name, args, cfg["seed"]).state_dict()

        def fresh(dev, name=name, args=args, weights=weights, loss_fn=loss_fn, precision="f32"):
            model = get(name)(**args, device=dev)
            model.load_state_dict(weights)
            opt = make_optimizer(model.parameters(), cfg["lr"])
            return model, make_train_step(model, loss_fn, opt, precision, clip_norm=cfg["clip"])

        model, step = fresh(device)
        # The first steps on the batch: phase 10's float32 side of the bf16 rule.
        f32_trace = [float(step(x, y)) for _ in range(cfg["bf16_steps"])]
        check(np.isfinite(f32_trace).all(), f"{stem} step: loss not finite {f32_trace}")
        ms = median_ms(lambda step=step: step(x, y), device, reps=cfg["reps"],
                       warmup=cfg["warmup"])
        mib = _peak_mib(device, lambda step=step: step(x, y))
        with torch.no_grad():
            metric = float(metric_fn(model(x), y))
        check(np.isfinite(metric), f"{stem}: metric {metric}")
        del model, step
        b16 = train_bf16(device, stem, fresh, x, y, f32_trace, cfg)
        chk = enh_step_check(fresh, xc, yc, device)
        _step_check_ok(chk, stem)
        stats[stem] = dict(model=name, params=chk["params"], ms=ms,
                           audio_s_per_s=audio_s / (ms / 1e3), peak_mib=mib, metric=metric,
                           bf16=b16, **{k: v for k, v in chk.items() if k not in ("params", "ill")})
        print(f"enh-train[{stem}: {name}]: {chk['params']} trained parameters, seeded, "
              f"{loss_node[0]} / {metric_node[0]}, Adam lr {cfg['lr']}, optax clip "
              f"{cfg['clip']}, fp32, B={cfg['batch']} x {cfg['crop_s']:g} s from phase 8's split: "
              f"{ms:.4f} ms/step = {audio_s / (ms / 1e3):.1f} audio-s/s (CUDA-event median of "
              f"{cfg['reps']} after {cfg['warmup']}), peak extra memory "
              f"{mib if mib is None else round(mib, 1)} MiB, {metric_node[0]} {metric:.4f}; one "
              f"step on B={cfg['check_batch']} x {cfg['check_s']:g} s vs the CPU "
              f"({chk['cpu_s']:.2f} s there), {_step_check_line(chk)}; "
              f"{train_bf16_line(b16, cfg, audio_s)}; {smi}", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # A short fit of one config through the train CLI's path, resumed for one
    # more epoch; val on the split's fixed enhancement remix.
    name, args = models[cfg["fit_model"]]
    val = generate_fixed_eval.main(["--in_dir", str(split), "--out_dir", str(root / "val-enh"),
                                    "--task", "enhancement", "--seed", str(cfg["seed"]),
                                    "--device", str(device)])
    conf = _enh_fit_config(cfg, name, args, split, val, root / "exp")
    exp = root / "exp" / name
    train_from_config(conf, device)
    resumed = train_from_config(conf, device, max_epochs=cfg["fit_epochs"] + 1, resume=True)
    records = [json.loads(ln) for ln in (exp / "metrics.jsonl").read_text().splitlines()]
    want = list(range(-1, cfg["fit_epochs"] + 1))
    check([r["epoch"] for r in records] == want and all(np.isfinite(r["val_loss"])
                                                        for r in records),
          f"{name} fit: metrics.jsonl {records}")
    top = json.loads((exp / "best_k_models.json").read_text())
    best = min(top, key=top.get)
    check((exp / "best_model.pkl").read_bytes() == Path(best).read_bytes(),
          "best_model.pkl is not the best top-k checkpoint")
    last = [p for p in top if Path(p).name.startswith(f"epoch={cfg['fit_epochs']}-")]
    xv = x[:1]
    with torch.inference_mode():
        reloaded = from_pretrain(exp / "best_model.pkl", device=device)
        check(type(reloaded).__name__ == name, f"best_model.pkl built {type(reloaded).__name__}")
        out = reloaded(xv)
        check(all(bool(torch.isfinite(o).all()) for o in out), "best_model.pkl: output not finite")
        if last:
            # The pack holds flax's one LSTM bias per gate (bias_ih + bias_hh),
            # so the reloaded model is the trained one's function to float32
            # rounding, and its pack the same tree exactly.
            packed = serialize(resumed.model)["state_dict"]
            with open(last[0], "rb") as f:
                saved = pickle.load(f)["state_dict"]
            flat = [(a, b) for a, b in zip(_flat_leaves(packed), _flat_leaves(saved))]
            check(len(flat) == len(_flat_leaves(packed)) and all(
                ka == kb and np.array_equal(va, vb) for (ka, va), (kb, vb) in flat),
                "the last epoch's pack is not the trained model's")
            want_out = resumed.model.eval()(xv)
            got_out = from_pretrain(last[0], device=device)(xv)
            err = max(float((a - b).abs().max()) for a, b in zip(got_out, want_out))
            peak = max(float(a.abs().max()) for a in want_out)
            check(err <= PACK_REL * peak, f"the last epoch's pack vs the trained model: max abs "
                  f"err {err} (max|out| {peak})")
    print(f"enh-train[fit {cfg['fit_model']}]: {cfg['fit_samples']} samples x "
          f"{cfg['crop_s']:g} s per epoch, batch {cfg['batch']}, val on the split's fixed "
          f"enhancement remix (clean.wav targets, {cfg['crop_s']:g} s crops), TF32 off: s/epoch "
          f"{[round(r['seconds'], 3) for r in records]} (epochs {[r['epoch'] for r in records]}, "
          f"-1 the baseline val, {cfg['fit_epochs']} resumed), train loss "
          f"{[round(r['train_loss'], 4) for r in records if 'train_loss' in r]}, val "
          f"{[round(r['val_loss'], 4) for r in records]}; best_model.pkl = {Path(best).name}, "
          f"read back by from_pretrain as {name}"
          + (f"; the last epoch's pack the trained model's tree exactly, its outputs within "
             f"{err:.3g} of max|out| {peak:.3g} (tol {PACK_REL}·max|out|)" if last else ""),
          flush=True)
    stats["fit"] = dict(model=cfg["fit_model"], s_per_epoch=[r["seconds"] for r in records])
    return stats


def sep_train_fresh(stem: str, weights: dict, cfg=SEP_TRAIN):
    """``fresh(dev, dtype=float32)`` for ``enh_step_check``: config
    ``stem``'s model at ``cfg``'s widths with ``weights`` on ``dev``, and
    its train step (the config's optimizer and clip, PIT neg-SNR)."""
    import torch

    from sonicsim_tpu_torch.losses import PairwiseNegSDR, PITLossWrapper
    from sonicsim_tpu_torch.models import get
    from sonicsim_tpu_torch.train import make_optimizer, make_train_step

    name, lr, wd = cfg["configs"][stem]
    loss_fn = PITLossWrapper(PairwiseNegSDR("snr"), pit_from="pw_mtx", threshold_byloss=False)

    def fresh(dev, dtype=torch.float32, precision="f32"):
        model = get(name)(**cfg["models"][name], device=dev).to(dtype)
        model.load_state_dict(weights)
        opt = make_optimizer(model.parameters(), lr, wd)
        return model, make_train_step(model, loss_fn, opt, precision, clip_norm=cfg["clip"])

    return fresh


def _step_check_line(chk: dict) -> str:
    """``enh_step_check``'s readings against their bounds, as phases 14 and
    15 print them."""
    rel = chk["bound"] / chk["grad_max"]
    return (f"every side on the device's branch at each of {chk['kinks']} kinked activation "
            f"and loss minimum calls ({chk['flips']} elements or rows sent apart, within "
            f"{chk['flip_rel']:.3g}·max|x|, tol {KINK_REL}): float64 on the device "
            f"{chk['device_f64_err']:.3g}·max|g64| from float64 on the CPU "
            f"({chk['device_f64_worst']}; tol {F64_REL}; {chk['device_f64_s']:.2f} s there); "
            f"float32 loss rel {chk['loss_rel']:.3g} (tol {TRAIN_LOSS_REL}), "
            f"gradients max abs err {chk['grad_err']:.3g} ({chk['worst']}) of max|g| "
            f"{chk['grad_max']:.3g} = {chk['grad_err'] / chk['grad_max']:.3g}·max|g| (tol "
            f"{rel:.3g}·max|g|"
            f"{f', {ILL_FACTOR} times the CPU float32 distance from float64' if chk['ill'] else ''}"
            f"; the CPU's float32 {chk['cpu_vs_f64']:.3g} (the larger of its default and two "
            f"threads, which lie {chk['cpu_vs_cpu2']:.3g}·max|g| apart), the device's "
            f"{chk['device_vs_f64']:.3g}·max|g64| from float64 on the CPU)")


def step_check_failures(chk: dict) -> list:
    """The readings of ``enh_step_check`` past their bounds, by name."""
    return [name for name, bad in (
        ("device_f64_err", chk["device_f64_err"] > F64_REL),
        ("loss_rel", chk["loss_rel"] > TRAIN_LOSS_REL),
        ("grad_err", chk["grad_err"] > chk["bound"]),
        ("flip_rel", chk["flip_rel"] > KINK_REL)) if bad]


def _step_check_ok(chk: dict, what: str) -> None:
    check(not step_check_failures(chk),
          f"{what} step on the device vs the CPU: float64 gradients "
          f"{chk['device_f64_err']}·max|g64| apart ({chk['device_f64_worst']}; tol {F64_REL}); "
          f"fp32 loss {chk['loss']} (rel {chk['loss_rel']}), gradients max abs err "
          f"{chk['grad_err']} ({chk['worst']}) over the bound {chk['bound']} (max|g| "
          f"{chk['grad_max']}, the CPU's float32 {chk['cpu_vs_f64']}·max|g64| from float64), or "
          f"a kinked activation's input {chk['flip_rel']}·max|x| from 0 sent apart (tol "
          f"{KINK_REL}): {step_check_failures(chk)}")


def phase_sep_training(device, cfg, folders, smi) -> dict:
    """Phase 15: each separation config's model trained in float32 with its
    config's optimizer, clip and PIT neg-SNR, from phase 11's seeded
    weights: the step's time and peak extra memory at the configs' batch
    and duration on phase 8's split, its bf16 step, and one step of the
    model at half its depth (``check_depth``) on the device against the
    same step on the CPU by ``enh_step_check``. Returns each config's
    numbers."""
    import torch

    from sonicsim_tpu_torch.dataset import MovingDataModule
    from sonicsim_tpu_torch.scripts.common import strict_float32

    strict_float32()
    split = folders[0].parent.parent
    dm = MovingDataModule(train_dir=str(split), val_dir=str(split), test_dir=str(split),
                          duration=cfg["crop_s"], num_samples=cfg["batch"],
                          batch_size=cfg["batch"], seed=cfg["seed"])
    mix, tgt = next(iter(dm.train_batches(0)))
    t_crop = int(cfg["crop_s"] * SR)
    check(tuple(tgt.shape) == (cfg["batch"], 2, t_crop), f"separation batch {tuple(tgt.shape)}")
    x, y = torch.from_numpy(mix).to(device), torch.from_numpy(tgt).to(device)
    audio_s = cfg["batch"] * cfg["crop_s"]
    stats = {}
    for stem, (name, lr, wd) in cfg["configs"].items():
        marks = [time.perf_counter()]
        weights = seeded_zoo(name, cfg["models"][name], cfg["seed"]).state_dict()
        fresh = sep_train_fresh(stem, weights, cfg)
        marks.append(time.perf_counter())
        model, step = fresh(device)
        n_params = sum(p.numel() for p in model.parameters() if p.requires_grad)
        # The first steps on the batch: phase 10's float32 side of the bf16 rule.
        f32_trace = [float(step(x, y)) for _ in range(cfg["bf16_steps"])]
        check(np.isfinite(f32_trace).all(), f"{stem} step: loss not finite {f32_trace}")
        ms = median_ms(lambda step=step: step(x, y), device, reps=cfg["reps"],
                       warmup=cfg["warmup"])
        mib = _peak_mib(device, lambda step=step: step(x, y))
        del model, step
        b16 = train_bf16(device, stem, fresh, x, y, f32_trace, cfg)
        marks.append(time.perf_counter())
        check_s, half = cfg["check_s"], check_depth(name, cfg["models"][name])
        depth = SEP_CHECK_DEPTH[name]
        xc, yc = _loudest_window(mix, tgt, cfg["check_batch"], int(check_s * SR))
        chk = enh_step_check(sep_train_fresh(stem, seeded_zoo(name, half, cfg["seed"]).state_dict(),
                                             dict(cfg, models={name: half})), xc, yc, device)
        _step_check_ok(chk, stem)
        marks.append(time.perf_counter())
        seconds = marks[-1] - marks[0]
        split_s = "/".join(f"{b - a:.1f}" for a, b in zip(marks, marks[1:]))
        stats[stem] = dict(model=name, params=n_params, ms=ms,
                           audio_s_per_s=audio_s / (ms / 1e3), peak_mib=mib, check_s=check_s,
                           seconds=seconds, bf16=b16, check_params=chk["params"],
                           **{k: v for k, v in chk.items() if k not in ("params", "ill")})
        print(f"sep-train[{stem}: {name}]: {n_params} trained parameters, seeded, PIT "
              f"neg-SNR, {'AdamW' if wd else 'Adam'} lr {lr:g}"
              f"{f' weight decay {wd:g}' if wd else ''}, optax clip {cfg['clip']}, fp32, "
              f"B={cfg['batch']} x {cfg['crop_s']:g} s from phase 8's split: {ms:.4f} ms/step = "
              f"{audio_s / (ms / 1e3):.1f} audio-s/s (CUDA-event median of {cfg['reps']} after "
              f"{cfg['warmup']}), peak extra memory {mib if mib is None else round(mib, 1)} MiB; "
              f"{train_bf16_line(b16, cfg, audio_s)}; one step at half depth ({depth} "
              f"{half[depth]}, {chk['params']} trained parameters) on B={cfg['check_batch']} x "
              f"{check_s:g} s vs the CPU ({chk['cpu_s']:.2f} s there), {_step_check_line(chk)}; "
              f"{seconds:.1f} s for the config (seeded weights / timing and bf16 / check "
              f"{split_s}); {smi}", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return stats


def c12_test_batch(x_shape: tuple, y_shape: tuple):
    """tests/test_torch_zoo_cuda.py::test_dprnn_train_step_on_the_card's
    batch: seeded noise, the targets at half the mixture's scale."""
    import torch

    rng = np.random.default_rng(1)
    xn = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32))
    yn = torch.from_numpy(0.5 * rng.standard_normal(y_shape).astype(np.float32))
    return xn, yn


_ONNX_DTYPES = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
                np.dtype(np.int32): 6, np.dtype(np.int64): 7, np.dtype(np.bool_): 9,
                np.dtype(np.float16): 10, np.dtype(np.float64): 11}


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # negative ints as 64-bit two's complement
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _field(num: int, payload) -> bytes:
    """One protobuf field: an int as a varint, bytes or str length-delimited."""
    if isinstance(payload, int):
        return _varint(num << 3) + _varint(payload)
    data = payload.encode() if isinstance(payload, str) else bytes(payload)
    return _varint(num << 3 | 2) + _varint(len(data)) + data


def _onnx_tensor(name: str, arr) -> bytes:
    arr = np.asarray(arr)  # tobytes() writes C order
    return (b"".join(_field(1, int(d)) for d in arr.shape) + _field(2, _ONNX_DTYPES[arr.dtype])
            + _field(8, name) + _field(9, arr.tobytes()))


def _onnx_attr(name: str, v) -> bytes:
    if isinstance(v, float):
        return _field(1, name) + _field(20, 1) + _varint(2 << 3 | 5) + np.float32(v).tobytes()
    if isinstance(v, int):
        return _field(1, name) + _field(20, 2) + _field(3, v)
    if isinstance(v, str):
        return _field(1, name) + _field(20, 3) + _field(4, v)
    if isinstance(v, np.ndarray):
        return _field(1, name) + _field(20, 4) + _field(5, _onnx_tensor("", v))
    if all(isinstance(x, int) for x in v):  # INTS, packed
        return _field(1, name) + _field(20, 7) + _field(8, b"".join(_varint(x) for x in v))
    return _field(1, name) + _field(20, 6) + _field(7, np.asarray(v, "<f4").tobytes())


def onnx_bytes(graph: dict) -> bytes:
    """A ModelProto's wire bytes for ``graph`` (``parse_onnx``'s dict: nodes,
    initializers, inputs, outputs), the subset the executors read."""
    g = b"".join(_field(1, b"".join([*(_field(1, i) for i in n["inputs"]),
                                     *(_field(2, o) for o in n["outputs"]), _field(4, n["op"]),
                                     *(_field(5, _onnx_attr(k, v))
                                       for k, v in n.get("attrs", {}).items())]))
                 for n in graph["nodes"])
    g += b"".join(_field(5, _onnx_tensor(k, v)) for k, v in graph["initializers"].items())
    g += b"".join(_field(11, _field(1, name)) for name in graph["inputs"])
    g += b"".join(_field(12, _field(1, name)) for name in graph["outputs"])
    return _field(1, 8) + _field(7, g)  # ir_version 8, graph


def _node(op: str, inputs: list, outputs: list, **attrs) -> dict:
    return {"op": op, "inputs": inputs, "outputs": outputs, "attrs": attrs}


def _seeded_weights(rng, **shapes) -> dict:
    """N(0, 1/fan_in) kernels and N(0, 0.01) vectors, float32."""
    return {k: (rng.standard_normal(s) / np.sqrt(np.prod(s[1:]) if len(s) > 1 else 100.0))
            .astype(np.float32) for k, s in shapes.items()}


def dnsmos_graphs(seed: int = 0) -> tuple[dict, dict]:
    """Seeded stand-ins for DNSMOS's two graphs at its shapes, from the
    executor's op set: sig_bak_ovr.onnx, the raw (N, 144160) waveform →
    (N, 3) SIG/BAK/OVRL, and model_v8.onnx, the (N, 900, 120) log-mel
    spectrogram → (N, 1) P.808 MOS, each in [1, 5]."""
    rng = np.random.default_rng(seed)
    w = _seeded_weights(rng, w1=(8, 1, 400), b1=(8,), w2=(16, 8, 1, 3), b2=(16,), w3=(3, 16),
                        b3=(3,))
    p835 = {"inputs": ["input_1"], "outputs": ["mos"], "initializers": {
        **w, "shape": np.array([0, 1, -1], np.int64), "ax2": np.array([2], np.int64),
        "four": np.float32(4.0), "one": np.float32(1.0)}, "nodes": [
        _node("Reshape", ["input_1", "shape"], ["x1"]),
        _node("Conv", ["x1", "w1", "b1"], ["c1"], strides=[160]),
        _node("Relu", ["c1"], ["r1"]),
        _node("Unsqueeze", ["r1", "ax2"], ["u1"]),
        _node("MaxPool", ["u1"], ["p1"], kernel_shape=[1, 4], strides=[1, 4]),
        _node("Conv", ["p1", "w2", "b2"], ["c2"], pads=[0, 1, 0, 1]),
        _node("Tanh", ["c2"], ["t2"]),
        _node("GlobalAveragePool", ["t2"], ["g2"]),
        _node("Flatten", ["g2"], ["f2"], axis=1),
        _node("Gemm", ["f2", "w3", "b3"], ["d3"], transB=1, alpha=1.0, beta=1.0),
        _node("Sigmoid", ["d3"], ["s3"]),
        _node("Mul", ["s3", "four"], ["m3"]),
        _node("Add", ["m3", "one"], ["mos"])]}
    w = _seeded_weights(rng, k1=(8, 1, 3, 3), c1=(8,), gamma=(8,), beta=(8,), k2=(16, 8, 3, 3),
                        c2=(16,), k3=(16, 1), c3=(1,))
    w["mean"] = (0.01 * rng.standard_normal(8)).astype(np.float32)
    w["var"] = (1.0 + rng.random(8)).astype(np.float32)
    w["gamma"] += 1.0
    p808 = {"inputs": ["input_1"], "outputs": ["p808"], "initializers": {
        **w, "axes23": np.array([2, 3], np.int64), "lo": np.float32(0.0), "hi": np.float32(6.0),
        "two": np.float32(2.0), "three": np.float32(3.0)}, "nodes": [
        _node("Unsqueeze", ["input_1"], ["u"], axes=[1]),
        _node("Conv", ["u", "k1", "c1"], ["a"], strides=[2, 2], auto_pad="SAME_UPPER"),
        _node("BatchNormalization", ["a", "gamma", "beta", "mean", "var"], ["bn"], epsilon=1e-5),
        _node("Relu", ["bn"], ["r"]),
        _node("AveragePool", ["r"], ["ap"], kernel_shape=[3, 3], strides=[2, 2],
              pads=[1, 1, 1, 1]),
        _node("Conv", ["ap", "k2", "c2"], ["b"], pads=[1, 1, 1, 1]),
        _node("Clip", ["b", "lo", "hi"], ["cl"]),
        _node("ReduceMean", ["cl", "axes23"], ["rm"], keepdims=0),
        _node("MatMul", ["rm", "k3"], ["mm"]),
        _node("Add", ["mm", "c3"], ["lin"]),
        _node("Tanh", ["lin"], ["th"]),
        _node("Mul", ["th", "two"], ["sc"]),
        _node("Add", ["sc", "three"], ["p808"])]}
    return p835, p808


def sigmos_graph(seed: int = 0) -> dict:
    """A seeded stand-in for SigMOS's graph at its features' shape,
    (1, 3, frames, 481) → (1, 7) in [1, 5], over the rest of the executor's
    op set: shape arithmetic on the host (Shape, Gather, Concat, Cast,
    Reshape), attention-style pooling (Transpose, Softmax, ReduceSum,
    ReduceMax), Slice, and the elementwise ops."""
    rng = np.random.default_rng(seed + 1)
    w = _seeded_weights(rng, k1=(8, 3, 3, 3), c1=(8,), w2=(7, 12), b2=(7,))
    return {"inputs": ["features"], "outputs": ["mos"], "initializers": {
        **w, "keep": np.array([0, 1], np.int64), "rest": np.array([-1], np.int64),
        "ax1": np.array([1], np.int64), "s0": np.array([0], np.int64),
        "e12": np.array([12], np.int64), "one": np.float32(1.0), "four": np.float32(4.0),
        "zero": np.float32(0.0), "floor": np.float32(-3.0), "five": np.float32(5.0),
        "two": np.float32(2.0),
        "ax2": np.array([2], np.int64)}, "nodes": [
        _node("Conv", ["features", "k1", "c1"], ["a"], strides=[1, 2], pads=[1, 1, 1, 1]),
        _node("Relu", ["a"], ["r"]),
        _node("MaxPool", ["r"], ["p"], kernel_shape=[2, 2], strides=[2, 2]),
        _node("Shape", ["p"], ["shp"]),
        _node("Gather", ["shp", "keep"], ["lead"], axis=0),
        _node("Concat", ["lead", "rest"], ["shape"], axis=0),
        _node("Cast", ["shape"], ["shape64"], to=7),
        _node("Reshape", ["p", "shape64"], ["flat"]),
        _node("Transpose", ["flat"], ["t"], perm=[0, 2, 1]),
        _node("Softmax", ["t"], ["att"], axis=1),
        _node("Mul", ["att", "t"], ["wt"]),
        _node("ReduceSum", ["wt", "ax1"], ["pooled"], keepdims=0),
        _node("ReduceMax", ["t"], ["peak"], axes=[1], keepdims=0),
        _node("Concat", ["pooled", "peak"], ["both"], axis=1),
        _node("Slice", ["both", "s0", "e12", "ax1"], ["z"]),
        _node("Pow", ["z", "two"], ["z2"]),
        _node("Add", ["z2", "one"], ["z21"]),
        _node("Log", ["z21"], ["lg"]),
        _node("Exp", ["lg"], ["ex"]),
        _node("Sqrt", ["ex"], ["norm"]),
        _node("Div", ["z", "norm"], ["unit"]),
        _node("Sub", ["unit", "zero"], ["centred"]),
        _node("Gemm", ["centred", "w2", "b2"], ["d"], transB=1),
        _node("Max", ["d", "floor"], ["pos"]),
        _node("Min", ["pos", "five"], ["capped"]),
        _node("Unsqueeze", ["capped", "ax2"], ["u"]),
        _node("Squeeze", ["u", "ax2"], ["sq"]),
        _node("Identity", ["sq"], ["id"]),
        _node("Sigmoid", ["id"], ["s"]),
        _node("Mul", ["s", "four"], ["m"]),
        _node("Add", ["m", "one"], ["mos"])]}


def _host_median_s(fn, reps: int) -> float:
    """Median host seconds of ``reps`` calls of ``fn``."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _graph_vs_cpu(card, cpu, x, what: str) -> tuple[float, float]:
    """``card`` and ``cpu`` (one graph on two devices) on ``x``: max abs
    error and max|ref|, held to ``ONNX_REL``."""
    ref = cpu(x)[0]
    got = card(x)[0].cpu()
    err, peak = float((got - ref).abs().max()), float(ref.abs().max())
    check(tuple(got.shape) == tuple(ref.shape) and _finite(got),
          f"{what}: output {tuple(got.shape)} vs {tuple(ref.shape)}")
    check(err <= ONNX_REL * peak, f"{what} on the device vs the CPU: max abs err {err} "
          f"(max|ref| {peak})")
    return err, peak


def _finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def phase_eval_sidecars(device, cfg, folders, root: Path, smi) -> dict:
    """Phase 16: the weightless evaluation sidecars on the device against
    the CPU. DNSMOS and SigMOS over seeded graphs written as .onnx files
    and read back by the executor (``DNSMOS``, ``make_dnsmos``, ``SigMOS``,
    ``make_sigmos_all``) on a ``cfg["clip_s"]`` clip of phase 8's first
    mixture, each graph held to the CPU and the ms per clip timed;
    ``wav_chunk_inference`` of a zoo model over a stretch of that mixture;
    the composite measures' host seconds per 60 s mixture beside PESQ's and
    STOI's. Returns the numbers."""
    import torch

    from sonicsim_tpu_torch.infer import wav_chunk_inference
    from sonicsim_tpu_torch.metrics import (
        DNSMOS,
        SigMOS,
        audio_melspec,
        composite_measures,
        make_dnsmos,
        make_sigmos_all,
        pesq,
        sigmos_features,
        sigmos_stft,
        stoi,
    )
    from sonicsim_tpu_torch.scripts.common import make_forward, strict_float32
    from sonicsim_tpu_torch.utils import read_wav

    strict_float32()
    root.mkdir()
    mono = _mono_mixes(folders)[0]
    clip = mono[:int(cfg["clip_s"] * SR)].copy()
    cpu = torch.device("cpu")
    stats = {}

    # DNSMOS: the two graphs at its shapes, as files.
    p835, p808 = dnsmos_graphs(cfg["seed"])
    (root / "dnsmos").mkdir()
    (root / "dnsmos" / "sig_bak_ovr.onnx").write_bytes(onnx_bytes(p835))
    (root / "dnsmos" / "model_v8.onnx").write_bytes(onnx_bytes(p808))
    card, host = DNSMOS(root / "dnsmos", device), DNSMOS(root / "dnsmos", cpu)
    seg = clip[None, :].astype(np.float32)
    mel = audio_melspec(clip[:-160])[None]
    check(mel.shape == (1, 900, 120), f"DNSMOS mel {mel.shape}")
    errs = {"p835": _graph_vs_cpu(card.p835, host.p835, seg, "DNSMOS P.835 graph"),
            "p808": _graph_vs_cpu(card.p808, host.p808, mel, "DNSMOS P.808 graph")}
    got, want = card(clip, SR), host(clip, SR)
    check(got["num_hops"] == want["num_hops"] == 1 and all(
        abs(got[k] - want[k]) <= ONNX_REL * abs(want[k]) for k in want if k != "num_hops"),
        f"DNSMOS on the device {got} vs the CPU {want}")
    metric = make_dnsmos(root / "dnsmos", device=device)
    check(abs(metric(None, clip, SR) - got["OVRL"]) <= ONNX_REL * abs(got["OVRL"]),
          "make_dnsmos does not score the estimate")
    reps = cfg["reps"]
    clip_ms = 1e3 * _host_median_s(lambda: card(clip, SR), reps)
    graph_ms = median_ms(lambda: (card.p835(seg), card.p808(mel)), device, reps=reps,
                         warmup=cfg["warmup"])
    stats["dnsmos"] = dict(ms_per_clip=clip_ms, graph_ms=graph_ms, **{
        f"{k}_err": e for k, (e, _) in errs.items()}, scores=got)
    print(f"eval[DNSMOS]: seeded stand-in graphs at DNSMOS's shapes (P.835 on the raw "
          f"{cfg['clip_s']:g} s clip, {len(p835['nodes'])} nodes; P.808 on audio_melspec "
          f"{mel.shape}, {len(p808['nodes'])} nodes), written as .onnx and read back; on the "
          f"device vs the CPU, TF32 off: max abs err {errs['p835'][0]:.3g} of max|ref| "
          f"{errs['p835'][1]:.3g} and {errs['p808'][0]:.3g} of {errs['p808'][1]:.3g} (tol "
          f"{ONNX_REL}·max|ref|); scores {({k: round(v, 4) for k, v in got.items()})}; "
          f"{clip_ms:.4f} ms per clip with the host features (median of {reps}), the two "
          f"graphs {graph_ms:.4f} ms (CUDA-event median of {reps} after {cfg['warmup']}); "
          f"make_dnsmos scores the estimate; {smi}", flush=True)

    # SigMOS: its 48 kHz features of the same clip through a seeded graph.
    (root / "sigmos.onnx").write_bytes(onnx_bytes(sigmos_graph(cfg["seed"])))
    card, host = SigMOS(root / "sigmos.onnx", device), SigMOS(root / "sigmos.onnx", cpu)
    from scipy.signal import resample

    up = resample(clip, int(np.ceil(len(clip) * SigMOS.SAMPLING_RATE / SR))).astype(np.float32)
    feats = sigmos_features(sigmos_stft(up))
    err = _graph_vs_cpu(card.model, host.model, feats, "SigMOS graph")
    got, want = card(clip, SR), host(clip, SR)
    check(all(abs(got[k] - want[k]) <= ONNX_REL * abs(want[k]) for k in want),
          f"SigMOS on the device {got} vs the CPU {want}")
    columns = make_sigmos_all(root / "sigmos.onnx", device=device)
    check(sorted(columns) == sorted(SigMOS.AXES) and all(
        abs(columns[k](None, clip, SR) - got[k]) <= ONNX_REL * abs(got[k]) for k in SigMOS.AXES),
        "make_sigmos_all's columns are not SigMOS's axes on the estimate")
    clip_ms = 1e3 * _host_median_s(lambda: card(clip, SR), reps)
    graph_ms = median_ms(lambda: card.model(feats), device, reps=reps, warmup=cfg["warmup"])
    stats["sigmos"] = dict(ms_per_clip=clip_ms, graph_ms=graph_ms, err=err[0], scores=got)
    print(f"eval[SigMOS]: a seeded stand-in graph ({len(sigmos_graph()['nodes'])} nodes) on "
          f"the 48 kHz features {feats.shape} of the clip; on the device vs the CPU: max abs err "
          f"{err[0]:.3g} of max|ref| {err[1]:.3g} (tol {ONNX_REL}·max|ref|); "
          f"{clip_ms:.4f} ms per clip with the resample and features on the host (median of "
          f"{reps}), the graph {graph_ms:.4f} ms (CUDA-event median); make_sigmos_all's 7 "
          f"columns; {smi}", flush=True)

    # wav_chunk_inference of a zoo model over a stretch of the mixture.
    name = cfg["chunk_model"]
    model = seeded_zoo(name, cfg["models"][name], cfg["seed"])
    fwd_cpu = make_forward(model)
    model_dev = seeded_zoo(name, cfg["models"][name], cfg["seed"])
    model_dev.place(device)
    fwd_dev = make_forward(model_dev)
    piece = mono[:int(cfg["chunk_s"] * SR)].copy()
    ref = wav_chunk_inference(fwd_cpu, piece, SR, device=cpu, **cfg["chunk"])
    got = wav_chunk_inference(fwd_dev, piece, SR, device=device, **cfg["chunk"])
    err, peak = float((got.cpu() - ref).abs().max()), float(ref.abs().max())
    check(tuple(got.shape) == (2, len(piece)) and _finite(got) and err <= ZOO_REL * peak,
          f"wav_chunk_inference on the device vs the CPU: {tuple(got.shape)}, max abs err "
          f"{err} (max|ref| {peak})")
    chunk_ms = median_ms(lambda: wav_chunk_inference(fwd_dev, piece, SR, device=device,
                                                     **cfg["chunk"]),
                         device, reps=reps, warmup=cfg["warmup"])
    stats["chunked"] = dict(model=name, err=err, ms=chunk_ms)
    print(f"eval[wav_chunk_inference]: {name} at full width (seeded) over "
          f"{cfg['chunk_s']:g} s of phase 8's first mixture, {cfg['chunk']}: on the device vs "
          f"the CPU max abs err {err:.3g} of max|ref| {peak:.3g} (tol {ZOO_REL}·max|ref|); "
          f"{chunk_ms:.4f} ms (CUDA-event median of {reps} after {cfg['warmup']}); {smi}",
          flush=True)
    del model_dev, fwd_dev

    # The composite measures on the host, per 60 s mixture (ROADMAP B11).
    n = int(cfg["composite_s"] * SR)
    folder = folders[0]
    src, _ = read_wav(folder / sorted(p.name for p in folder.glob("moving_audio_1*.wav"))[0])
    ref_track = src.mean(axis=0)[:n].astype(np.float64)
    deg = mono[:n].astype(np.float64)
    host_s = {}
    t0 = time.perf_counter()
    comp = composite_measures(ref_track, deg, SR)
    host_s["composite (with its PESQ)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p = pesq(ref_track, deg, SR, "wb")
    host_s["PESQ wb"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    s = stoi(ref_track, deg, SR)
    host_s["STOI"] = time.perf_counter() - t0
    check(all(np.isfinite(v) for v in comp.values()) and np.isfinite(p) and np.isfinite(s),
          f"composite measures {comp}, PESQ {p}, STOI {s}")
    stats["composite"] = dict(seconds=host_s, values=comp)
    print(f"eval[composite]: CSIG/CBAK/COVL of moving_audio_1 against the mixture, "
          f"{cfg['composite_s']:g} s: {({k: round(v, 4) for k, v in comp.items()})}; host "
          f"seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in host_s.items())
          + f" (PESQ {p:.4f}, STOI {s:.4f}); {smi}", flush=True)
    return stats


def seeded_state_dict(shapes: dict, seed: int, device=None) -> dict:
    """Float32 CPU tensors for a state dict's ``shapes`` (name → shape),
    drawn in sorted key order from a generator seeded ``seed`` on ``device``
    (the CPU unless given; a full-width Whisper is 769 M numbers): weights
    of two or more axes N(0, 1/fan_in), token and position tables
    N(0, 0.02²), 1-D weights (norm gains) 1 + N(0, 0.1²), running variances
    0.5 + |N(0, 0.1²)|, biases, running means and the rest N(0, 0.1²);
    ``num_batches_tracked`` 1000."""
    import torch

    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(seed)
    out = {}
    for key in sorted(shapes):
        shape, leaf = tuple(shapes[key]), key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            out[key] = torch.tensor(1000)
            continue
        x = torch.randn(shape, generator=gen, device=gen.device)
        if "embed_tokens" in key or "embed_positions" in key:
            x = 0.02 * x
        elif leaf.startswith("weight") and len(shape) >= 2:
            x = x / float(np.sqrt(np.prod(shape[1:])))
        elif leaf == "weight":
            x = 1.0 + 0.1 * x
        elif leaf == "running_var":
            x = 0.5 + (0.1 * x).abs()
        else:
            x = 0.1 * x
        out[key] = x.cpu()
    return out


def whisper_en_vocab() -> tuple[dict, dict]:
    """(vocab.json, added_tokens.json) of an English-only Whisper with its
    specials at the released ids: 50,256 byte-level tokens (GPT-2's 256
    printable byte stand-ins, then pairs of them) and <|endoftext|> 50256;
    added, <|startoftranscript|> 50257, the language tokens 50258-50356,
    <|translate|> 50357, <|transcribe|> 50358, <|startoflm|> 50359,
    <|startofprev|> 50360, <|nocaptions|> 50361 and <|notimestamps|>
    50362."""
    from sonicsim_tpu_torch.models.whisper import _byte_decoder

    chars = list(_byte_decoder())
    vocab = {c: i for i, c in enumerate(chars)}
    for i in range(256, 50256):
        a, b = divmod(i - 256, 256)
        vocab[chars[a] + chars[b]] = i
    vocab["<|endoftext|>"] = 50256
    added = {"<|startoftranscript|>": 50257, "<|en|>": 50258}
    added.update({f"<|lang{k}|>": 50258 + k for k in range(1, 99)})
    added.update({"<|translate|>": 50357, "<|transcribe|>": 50358, "<|startoflm|>": 50359,
                  "<|startofprev|>": 50360, "<|nocaptions|>": 50361, "<|notimestamps|>": 50362})
    return vocab, added


def write_whisper_hf(path: Path, cfg: dict, seed: int, device=None) -> Path:
    """A seeded Whisper of ``cfg``'s widths as an HF directory: config.json,
    pytorch_model.bin (``model.``-prefixed, the tied ``proj_out``; the
    encoder's positions its sinusoids), vocab.json and added_tokens.json
    (:func:`whisper_en_vocab`)."""
    import torch

    from sonicsim_tpu_torch.models import whisper as W

    wcfg = W.WhisperConfig(**cfg)
    shapes = {k: v.shape for k, v in W.Whisper(wcfg, device="meta").state_dict().items()}
    sd = seeded_state_dict(shapes, seed, device)
    sd["encoder.embed_positions.weight"] = torch.from_numpy(
        W.sinusoids(wcfg.max_source_positions, wcfg.d_model))
    hf = {f"model.{k}": v for k, v in sd.items()}
    hf["proj_out.weight"] = hf["model.decoder.embed_tokens.weight"]
    path.mkdir(parents=True)
    torch.save(hf, path / "pytorch_model.bin")
    (path / "config.json").write_text(json.dumps({
        "model_type": "whisper", "vocab_size": wcfg.vocab_size, "num_mel_bins": wcfg.n_mels,
        "d_model": wcfg.d_model, "encoder_layers": wcfg.encoder_layers,
        "decoder_layers": wcfg.decoder_layers, "encoder_attention_heads": wcfg.heads,
        "decoder_attention_heads": wcfg.heads, "encoder_ffn_dim": wcfg.ffn,
        "decoder_ffn_dim": wcfg.ffn, "max_source_positions": wcfg.max_source_positions,
        "max_target_positions": wcfg.max_target_positions}))
    vocab, added = whisper_en_vocab()
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "added_tokens.json").write_text(json.dumps(added))
    return path


def write_ecapa_ckpt(path: Path, widths: dict, seed: int, device=None) -> Path:
    """A seeded ECAPA-TDNN of ``widths`` as speechbrain's
    embedding_model.ckpt (each BatchNorm with its num_batches_tracked)."""
    import torch

    from sonicsim_tpu_torch.models.ecapa import EcapaTdnn

    shapes = {k: v.shape for k, v in EcapaTdnn(**widths, device="meta").state_dict().items()}
    shapes.update({k.replace("running_mean", "num_batches_tracked"): ()
                   for k in shapes if k.endswith(".running_mean")})
    torch.save(seeded_state_dict(shapes, seed, device), path)
    return path


# The seeded VAD's LSTMs: the plain draw's speech probability jitters (155
# spans in a 60 s mixture); a long memory (forget-gate bias +6 with the
# plain recurrent draw) is chaotic, its float32 and float64 probabilities
# parting by 0.99 on the CPU. Input and recurrent weights at a tenth and a
# fifth of the draw and a forget-gate bias of +3 make a contracting state
# that moves on the scale of 20 frames (a third of a second): 2-3 spans a
# mixture, float32 within 5e-6 of float64 (phase 8's mixtures, the CPU).
LSTM_INPUT_SCALE, LSTM_RECURRENT_SCALE, LSTM_FORGET_BIAS = 0.1, 0.2, 3.0


def write_pyannet_ckpt(path: Path, widths: dict, seed: int, wav: np.ndarray,
                       device=None) -> Path:
    """A seeded PyanNet of ``widths`` as a pyannote lightning checkpoint
    (``state_dict`` of ``model.``-prefixed names; its LSTM biases drawn
    apart in ``bias_ih`` and ``bias_hh``, ROADMAP C11): the cutoffs from
    :func:`seeded_sinc`, the LSTMs slowed (``LSTM_*``), the classifier's
    kernel 30 times the draw and its
    bias centring the logits of ``wav`` on 0, so that the speech
    probability crosses 0.5 (the plain draw keeps it near 0.5). The
    centring runs on ``device``."""
    import torch

    from sonicsim_tpu_torch.models.pyannet import PyanNet, pyannet_from_state_dict

    shapes = {k: v.shape for k, v in PyanNet(**widths, device="meta").state_dict().items()}
    sd = seeded_state_dict(shapes, seed, device)
    low, band = seeded_sinc(shapes["sincnet.conv1d.0.filterbank.low_hz_"][0], seed)
    sd["sincnet.conv1d.0.filterbank.low_hz_"] = torch.from_numpy(low)
    sd["sincnet.conv1d.0.filterbank.band_hz_"] = torch.from_numpy(band)
    for key in [k for k in sd if k.startswith("lstm.")]:
        if key.startswith("lstm.weight_ih"):
            sd[key] = LSTM_INPUT_SCALE * sd[key]
        elif key.startswith("lstm.weight_hh"):
            sd[key] = LSTM_RECURRENT_SCALE * sd[key]
        elif key.startswith("lstm.bias_ih"):  # gates i, f, g, o: the forget gate's
            hidden = sd[key].shape[0] // 4
            sd[key][hidden:2 * hidden] += LSTM_FORGET_BIAS
    sd["classifier.weight"] = 30 * sd["classifier.weight"]
    sd["classifier.bias"] = torch.zeros_like(sd["classifier.bias"])
    model = pyannet_from_state_dict(sd, device)
    with torch.inference_mode():
        p = model(torch.from_numpy(wav)[None].to(next(model.parameters()).device))
    p = p[0].amax(-1).double().cpu()
    sd["classifier.bias"] -= float(torch.median(torch.log(p / (1 - p))))
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}}, path)
    return path


def _whisper_hold(device, model, cpu_model, chunk, sot, eot, sup, tf_positions: int) -> dict:
    """``model`` (on the device) against ``cpu_model`` (the same weights on
    the CPU) on one 30 s window ``chunk``: the log-mel, the encoder output
    and the teacher-forced logits of the first ``tf_positions`` positions
    within ``SIDECAR_REL`` · max|ref|; the device's greedy tokens equal to
    the CPU's argmax (teacher-forced on those tokens) up to the first free
    position whose CPU top-2 logit gap is below the same tolerance."""
    import torch

    from sonicsim_tpu_torch.models import whisper as W

    def rel(a, b, what):
        err, peak = float((a.cpu() - b).abs().max()), float(b.abs().max())
        check(tuple(a.shape) == tuple(b.shape) and _finite(a) and err <= SIDECAR_REL * peak,
              f"Whisper {what} on the device vs the CPU: {tuple(a.shape)}, max abs err {err} "
              f"(max|ref| {peak})")
        return err / peak

    n_mels = model.cfg.n_mels
    with torch.inference_mode():
        mel_dev = W.log_mel(chunk.to(device), n_mels)
        mel_cpu = W.log_mel(chunk, n_mels)
        out = dict(mel=rel(mel_dev, mel_cpu, "log-mel"))
        t0 = time.perf_counter()
        enc_cpu = cpu_model.encode(mel_cpu)
        enc_dev = model.encode(mel_dev)
        out["encoder"] = rel(enc_dev, enc_cpu, "encoder output")
        toks = W.greedy_decode(model, mel_dev, sot, eot, suppress=sup,
                               max_len=min(model.cfg.max_target_positions, len(sot) + 224))
        toks = toks.cpu()
        gen = toks[0, len(sot):]
        stop = int((gen == eot).nonzero()[0]) + 1 if bool((gen == eot).any()) else len(gen)
        n = len(sot) + stop
        logits_cpu = cpu_model.decode(toks[:, :n], enc_cpu)
        out["cpu_s"] = time.perf_counter() - t0
        k = min(tf_positions, n)
        out["logits"] = rel(model.decode(toks[:, :k].to(device), enc_dev), logits_cpu[:, :k],
                            f"teacher-forced logits of {k} positions")
    masked = logits_cpu[0, len(sot) - 1:n - 1].masked_fill(torch.from_numpy(sup), -torch.inf)
    top2 = masked.topk(2, dim=-1)
    gap = (top2.values[:, 0] - top2.values[:, 1]) / float(logits_cpu.abs().max())
    near = (gap < SIDECAR_REL).nonzero()
    held = int(near[0]) if len(near) else len(gap)
    agree = bool((top2.indices[:held, 0] == toks[0, len(sot):len(sot) + held]).all())
    check(agree, f"Whisper greedy tokens on the device part from the CPU's argmax before its "
          f"first near-tie (position {held} of {len(gap)})")
    out.update(tokens=len(gap), held=held, min_gap=float(gap.min()))
    return out


def phase_sidecar_models(device, cfg, folders, root: Path, pack: Path, smi) -> dict:
    """Phase 17: the sidecar models on the device against the CPU, at their
    published widths with seeded weights written in each checkpoint's own
    format. Whisper medium.en (an HF directory) through ``make_whisper_asr``
    on one 30 s window of phase 8's first mixture, greedy and beam 5 with
    the temperature fallback, and ``_whisper_hold``; ECAPA at
    spkrec-ecapa-voxceleb's widths embedding 10 s of each speech track, and
    ``inference --ecapa`` with phase 9's ConvTasNet pack; PyanNet's frame
    probabilities and spans on the 60 s mixture, and ``test --vad_ckpt
    --whisper --limit 1`` over phase 8's split. Returns the numbers."""
    import csv

    import torch

    from sonicsim_tpu_torch.metrics import make_whisper_asr
    from sonicsim_tpu_torch.models import ecapa as E
    from sonicsim_tpu_torch.models import pyannet as P
    from sonicsim_tpu_torch.models import whisper as W
    from sonicsim_tpu_torch.scripts import generate_fixed_eval, inference
    from sonicsim_tpu_torch.scripts import test as test_cli
    from sonicsim_tpu_torch.scripts.common import strict_float32
    from sonicsim_tpu_torch.utils import read_wav, write_wav

    strict_float32()
    root.mkdir()
    cpu = torch.device("cpu")
    mono = _mono_mixes(folders)[0]
    reps = cfg["reps"]
    stats = {}

    # Whisper medium.en: the transcriber on the device, greedy and beam.
    t0 = time.perf_counter()
    wdir = write_whisper_hf(root / "whisper-medium.en", cfg["whisper"], cfg["seed"], device)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    asr = make_whisper_asr(str(wdir), device=device)
    load_s = time.perf_counter() - t0
    model = asr.model
    n_params = sum(p.numel() for p in model.parameters())
    window = mono[:W.CHUNK_SAMPLES].copy()
    tok = W.ByteBpeDecoder.from_dir(wdir)
    sot, eot = np.asarray(tok.sot_sequence()), tok.eot()
    sup = np.pad(tok.suppress_mask(), (0, model.cfg.vocab_size - len(tok.suppress_mask())),
                 constant_values=True)[:model.cfg.vocab_size]
    chunk = torch.from_numpy(W.pad_or_trim(window))
    with torch.inference_mode():
        mel_dev = W.log_mel(chunk.to(device), model.cfg.n_mels)
        W.greedy_decode(model, mel_dev, sot, eot, len(sot) + 8, sup)  # warm-up
        enc_ms = median_ms(lambda: model.encode(mel_dev), device, reps=reps, warmup=1)
    sync(device)
    resident = torch.cuda.memory_allocated(device) / 2**20 if device.type == "cuda" else None
    runs = {}
    for label, fn in (("greedy", asr), ("beam 5 with fallback", None)):
        if fn is None:
            fn = W.make_whisper_transcriber(wdir, beam_size=5, device=device)
        before, out = dict(fn.stats), {}

        def call(fn=fn, out=out):
            out["text"] = fn(window, SR)

        t0 = time.perf_counter()
        mib = _peak_mib(device, call) if device.type == "cuda" else call()
        wall = time.perf_counter() - t0
        steps = fn.stats["steps"] - before["steps"]
        runs[label] = dict(out, ms=1e3 * wall, steps=steps, ms_per_token=1e3 * wall / max(steps, 1),
                           decodes=fn.stats["decodes"] - before["decodes"], peak_mib=mib)
        check(isinstance(runs[label]["text"], str), f"Whisper {label}: no text")
        del fn
    if device.type == "cuda":
        torch.cuda.empty_cache()
    g = runs["greedy"]  # the encoder's share of a window out, per decoded token
    g["decode_ms_per_token"] = (g["ms"] - enc_ms) / max(g["steps"], 1)

    # The card against the CPU at full depth (the CPU side takes about 10 s
    # on an 8-core host of an H100).
    hold = _whisper_hold(device, model, W.load_whisper(wdir, device=cpu)[1], chunk, sot, eot,
                         sup, cfg["tf_positions"])
    stats["whisper"] = dict(params=n_params, write_s=write_s, load_s=load_s, encoder_ms=enc_ms,
                            resident_mib=resident, hold=hold,
                            **{k: {a: b for a, b in v.items() if a != "text"}
                               for k, v in runs.items()})
    print(f"sidecar[Whisper]: medium.en widths (d_model {model.cfg.d_model}, "
          f"{model.cfg.encoder_layers} + {model.cfg.decoder_layers} layers, "
          f"{model.cfg.heads} heads, vocab {model.cfg.vocab_size}), {n_params} parameters, "
          f"seeded, written as an HF directory in {write_s:.1f} s and loaded by "
          f"make_whisper_asr in {load_s:.1f} s ({resident if resident is None else round(resident)}"
          f" MiB resident); one 30 s window of phase 8's first mixture, TF32 off: "
          + " | ".join(f"{k}: {v['ms']:.1f} ms per window, {v['decodes']} decodes of "
                       f"{v['steps']} steps in all, {v['ms_per_token']:.3f} ms per decoded "
                       f"token, peak extra memory "
                       f"{v['peak_mib'] if v['peak_mib'] is None else round(v['peak_mib'], 1)} MiB"
                       for k, v in runs.items())
          + f" | the encoder {enc_ms:.3f} ms (CUDA-event median of {reps}), so greedy decodes "
          f"at {g['decode_ms_per_token']:.3f} ms per token; {smi}", flush=True)
    print(f"sidecar[Whisper vs the CPU]: {model.cfg.encoder_layers} + "
          f"{model.cfg.decoder_layers} layers, the CPU side {hold['cpu_s']:.1f} s: log-mel "
          f"{hold['mel']:.3g}, encoder output {hold['encoder']:.3g}, teacher-forced logits of "
          f"the first {min(cfg['tf_positions'], hold['tokens'] + 1)} positions "
          f"{hold['logits']:.3g} of max|ref| (tol {SIDECAR_REL}); the card's greedy tokens "
          f"are the CPU's argmax at all {hold['held']} free positions before the first whose "
          f"CPU top-2 gap is under {SIDECAR_REL}·max|logit| (of {hold['tokens']}; smallest "
          f"gap {hold['min_gap']:.3g})", flush=True)
    del model, asr
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ECAPA at spkrec-ecapa-voxceleb's widths: 10 s of each speech track.
    folder = folders[0]
    ckpt = write_ecapa_ckpt(root / "embedding_model.ckpt", cfg["ecapa"], cfg["seed"], device)
    emb_dev, emb_cpu = E.make_ecapa_embedder(ckpt, device), E.make_ecapa_embedder(ckpt, cpu)
    n = int(cfg["embed_s"] * SR)
    tracks = [read_wav(folder / name)[0].mean(axis=0)[:n]
              for name in sorted(p.name for p in folder.glob("moving_audio_*.wav"))]
    errs, cosines = [], []
    for track in tracks:
        x = torch.from_numpy(np.ascontiguousarray(track))
        with torch.inference_mode():
            got = emb_dev.model(E.ecapa_fbank(x.to(device)))[0].cpu()
            ref = emb_cpu.model(E.ecapa_fbank(x))[0]
        errs.append(float((got - ref).abs().max() / ref.abs().max()))
        cosines.append(float(np.dot(emb_dev(track), emb_cpu(track))))
        check(_finite(got) and errs[-1] <= SIDECAR_REL and cosines[-1] >= 1 - 1e-6,
              f"ECAPA on the device vs the CPU: max abs err {errs[-1]} of max|ref|, cosine "
              f"{cosines[-1]}")
    embed_ms = 1e3 * _host_median_s(lambda: emb_dev(tracks[0]), reps)
    n_params = sum(p.numel() for p in emb_dev.model.parameters())
    mib = _peak_mib(device, lambda: emb_dev(tracks[0]))
    del emb_dev, emb_cpu
    mix_path = root / "mix.wav"
    write_wav(mix_path, mono, SR, encoding="float32")
    t0 = time.perf_counter()
    inference.main(["--model_path", str(pack), "--mix", str(mix_path), "--out_dir",
                    str(root / "ecapa"), "--segment_seconds", str(cfg["segment_s"]), "--ecapa",
                    str(ckpt), "--device", str(device)])
    cli_s = time.perf_counter() - t0
    outs = sorted((root / "ecapa").glob("s*_est.wav"))
    check(len(outs) == 2 and all(read_wav(p)[0].shape == (1, len(mono))
                                 and np.isfinite(read_wav(p)[0]).all() for p in outs),
          f"inference --ecapa wrote {[p.name for p in outs]}")
    stats["ecapa"] = dict(params=n_params, err=max(errs), cosine=min(cosines), ms=embed_ms,
                          peak_mib=mib, cli_s=cli_s)
    print(f"sidecar[ECAPA]: spkrec-ecapa-voxceleb widths ({cfg['ecapa']}), {n_params} "
          f"parameters, seeded, from an embedding_model.ckpt; {len(tracks)} speech tracks of "
          f"phase 8's first mixture, {cfg['embed_s']:g} s each, on the device vs the CPU: "
          f"max abs err {max(errs):.3g} of max|ref| (tol {SIDECAR_REL}), cosine of the unit "
          f"embeddings ≥ {min(cosines):.9f} (tol 1 - 1e-6); {embed_ms:.3f} ms per "
          f"{cfg['embed_s']:g} s with the fbank (host median of {reps}), peak extra memory "
          f"{mib if mib is None else round(mib, 1)} MiB; inference --ecapa with phase 9's "
          f"ConvTasNet on the {len(mono) / SR:g} s mixture ({cfg['segment_s']:g} s windows): "
          f"{cli_s:.3f} s, load and WAV I/O included; {smi}", flush=True)

    # PyanNet at the JAX module's defaults: the 60 s mixture, then the CLI.
    ckpt = write_pyannet_ckpt(root / "pyannet.ckpt", cfg["pyannet"], cfg["seed"], mono, device)
    vad_dev, vad_cpu = P.make_neural_vad(ckpt, device=device), P.make_neural_vad(ckpt, device=cpu)
    with torch.inference_mode():
        got = vad_dev.model(torch.from_numpy(mono)[None].to(device))[0].amax(-1).cpu().numpy()
        ref = vad_cpu.model(torch.from_numpy(mono)[None])[0].amax(-1).numpy()
    times = vad_cpu.model.frame_times(len(mono))
    p_err = float(np.abs(got - ref).max())
    spans = vad_cpu(mono, SR)
    check(got.shape == ref.shape == times.shape and np.isfinite(got).all()
          and p_err <= SIDECAR_REL * float(np.abs(ref).max())
          and vad_spans_held(got, ref, times, SIDECAR_REL * float(np.abs(ref).max())),
          f"PyanNet on the device vs the CPU: max abs err {p_err}, or spans apart beyond the "
          f"frames within the tolerance of the threshold: {vad_dev(mono, SR)} vs {spans}")
    vad_ms = 1e3 * _host_median_s(lambda: vad_dev(mono, SR), reps)
    n_params = sum(p.numel() for p in vad_dev.model.parameters())
    del vad_dev, vad_cpu
    split = folders[0].parent.parent
    fixed = generate_fixed_eval.main(["--in_dir", str(split), "--out_dir", str(root / "fixed"),
                                      "--seed", str(cfg["seed"]), "--device", str(device)])
    conf = root / "test.yaml"  # JSON is YAML: no writer needed
    conf.write_text(json.dumps({"exp": {"dir": str(root / "exp"), "name": "convtasnet"},
                                "datas": {"test_dir": str(fixed), "sample_rate": SR,
                                          "num_spks": 2}}))
    t0 = time.perf_counter()
    res = test_cli.main(["--conf_dir", str(conf), "--model_path", str(pack), "--vad_ckpt",
                         str(ckpt), "--whisper", str(wdir), "--limit", "1", "--device",
                         str(device)])
    cli_s = time.perf_counter() - t0
    with open(res["csv"]) as f:
        table = list(csv.DictReader(f))
    scored = res["spans"] - res["skipped_silent"]
    col_s = res["column_s"]
    check(scored > 0 and "asr" in table[0] and len(table) == scored + 2
          and col_s.get("asr", 0) > 0, f"test --vad_ckpt --whisper: {res['spans']} spans, "
          f"{scored} scored, columns {list(table[0]) if table else None}, seconds {col_s}")
    stats["pyannet"] = dict(params=n_params, err=p_err, ms=vad_ms, spans=len(spans),
                            cli_s=cli_s, cli_spans=res["spans"], cli_scored=scored,
                            column_s=col_s)
    print(f"sidecar[PyanNet]: the JAX module's defaults ({cfg['pyannet']}), {n_params} "
          f"parameters, seeded, from a pyannote lightning checkpoint; phase 8's first "
          f"{len(mono) / SR:g} s mixture, {len(times)} frames: probabilities on the device vs "
          f"the CPU max abs err {p_err:.3g} (tol {SIDECAR_REL}·max|ref|), {len(spans)} spans "
          f"equal but at frames within the tolerance of the threshold; {vad_ms:.3f} ms per "
          f"mixture (host median of {reps}); test --vad_ckpt --whisper --limit 1 over the "
          f"split's fixed eval tree: {cli_s:.1f} s, {res['spans']} VAD spans ({scored} "
          f"scored, {res['skipped_silent']} with a silent reference), columns "
          f"{list(table[0])}; host seconds by column: "
          + ", ".join(f"{k} {v:.3f}" for k, v in col_s.items())
          + f"; forward {res['forward_s']:.3f} s; {smi}", flush=True)
    return stats


def phase_variants(device, cfg, folders, root: Path, smi) -> dict:
    """Phase 18: each model variant no config takes (``cfg["flags"]``) at its
    config's full width with seeded weights through the bridge and a pack on
    the card: the fp32 forward and ``to_waveform`` against the port on the
    CPU on a crop of phase 8's first mixture, the 10 s forward's time and
    peak extra memory, bf16 where ``require_bf16`` allows the variant (else
    its refusal), the config's train step at B=2 x 4 s (fp32 and, where
    allowed, bf16) and one step held to the CPU by ``enh_step_check``.
    Returns each variant's numbers."""
    import torch

    from sonicsim_tpu_torch.dataset import MovingDataModule
    from sonicsim_tpu_torch.infer.precision import variant_name
    from sonicsim_tpu_torch.models import from_pretrain, get, save_model
    from sonicsim_tpu_torch.scripts.common import make_forward, strict_float32
    from sonicsim_tpu_torch.train import make_optimizer, make_train_step

    strict_float32()
    root.mkdir()
    mono = _mono_mixes(folders[:1])[0]
    x10 = torch.from_numpy(mono[None, :int(cfg["window_s"] * SR)].copy()).to(device)
    crop = torch.from_numpy(mono[None, :int(cfg["crop_s"] * SR)].copy())
    split = folders[0].parent.parent
    dm = MovingDataModule(train_dir=str(split), val_dir=str(split), test_dir=str(split),
                          num_spks=1, duration=cfg["train_s"], num_samples=cfg["batch"],
                          batch_size=cfg["batch"], seed=cfg["seed"])
    mix, tgt = next(iter(dm.train_batches(0)))
    x, y = torch.from_numpy(mix).to(device), torch.from_numpy(tgt).to(device)
    xc, yc = _loudest_window(mix, tgt, cfg["check_batch"], int(cfg["check_s"] * SR))
    audio_s = cfg["batch"] * cfg["train_s"]
    stats = {}
    for stem, (config, flag) in cfg["flags"].items():
        name, base = cfg["models"][config]
        args = dict(base, **flag)
        t0 = time.perf_counter()
        cpu = seeded_zoo(name, args, cfg["seed"])
        label = variant_name(cpu)
        pack = root / f"{stem}.pkl"
        save_model(cpu, pack)
        model = from_pretrain(pack, device=device)
        check(variant_name(model) == label and label != name,
              f"{stem}: from_pretrain built {variant_name(model)}, not the variant {label}")
        build_s = time.perf_counter() - t0
        fwd = make_forward(model)
        t0 = time.perf_counter()
        ref = make_forward(cpu)(crop)
        cpu_s = time.perf_counter() - t0
        got = fwd(crop.to(device)).cpu()
        err, peak = float((got - ref).abs().max()), float(ref.abs().max())
        check(tuple(got.shape) == (1, 1, crop.shape[-1]) and bool(torch.isfinite(got).all()),
              f"{stem}: output {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
        check(err <= ZOO_REL * peak,
              f"{stem} on the device vs the CPU: max abs err {err} (max|ref| {peak})")
        ms = median_ms(lambda fwd=fwd: fwd(x10), device, reps=cfg["reps"], warmup=cfg["warmup"])
        mib = _peak_mib(device, lambda fwd=fwd: fwd(x10))
        b16 = serve_bf16(device, label, cpu, model, crop, got, x10, cfg)
        del fwd, model

        loss_node, _ = cfg["losses"][config]
        loss_fn = _instantiate_loss(loss_node)
        weights = cpu.state_dict()

        def fresh(dev, name=name, args=args, weights=weights, loss_fn=loss_fn, precision="f32"):
            m = get(name)(**args, device=dev)
            m.load_state_dict(weights)
            return m, make_train_step(m, loss_fn, make_optimizer(m, cfg["lr"]), precision,
                                      clip_norm=cfg["clip"])

        m, step = fresh(device)
        f32_trace = [float(step(x, y)) for _ in range(cfg["bf16_steps"])]
        check(np.isfinite(f32_trace).all(), f"{stem} step: loss not finite {f32_trace}")
        step_ms = median_ms(lambda step=step: step(x, y), device, reps=cfg["reps"],
                            warmup=cfg["warmup"])
        step_mib = _peak_mib(device, lambda step=step: step(x, y))
        del m, step
        b16t = train_bf16(device, label, fresh, x, y, f32_trace, cfg)
        chk = enh_step_check(fresh, xc, yc, device)
        _step_check_ok(chk, stem)
        stats[stem] = dict(model=label, params=chk["params"], err=err, max_ref=peak, ms=ms,
                           audio_s_per_s=cfg["window_s"] / (ms / 1e3), peak_mib=mib, bf16=b16,
                           step_ms=step_ms, step_audio_s_per_s=audio_s / (step_ms / 1e3),
                           step_peak_mib=step_mib, bf16_step=b16t,
                           **{k: v for k, v in chk.items() if k not in ("params", "ill")})
        print(f"variant[{stem}: {label}]: {chk['params']} trained parameters, seeded, from "
              f"{pack.name} via from_pretrain ({build_s:.2f} s with the build on the CPU); fp32 "
              f"forward and to_waveform vs the port on the CPU on a {cfg['crop_s']:g} s crop of "
              f"phase 8's first mixture ({cpu_s:.2f} s there): max abs err {err:.3g} of "
              f"max|ref| {peak:.3g} (tol {ZOO_REL}·max|ref|); B=1 x {cfg['window_s']:g} s: "
              f"{ms:.4f} ms = {stats[stem]['audio_s_per_s']:.1f} audio-s/s (CUDA-event median "
              f"of {cfg['reps']} after {cfg['warmup']}), peak extra memory "
              f"{mib if mib is None else round(mib, 1)} MiB; {bf16_line(b16, cfg)}; train "
              f"step ({loss_node[0]}, Adam lr {cfg['lr']}, clip {cfg['clip']}, fp32, "
              f"B={cfg['batch']} x {cfg['train_s']:g} s from phase 8's split): {step_ms:.4f} "
              f"ms/step = {audio_s / (step_ms / 1e3):.1f} audio-s/s, peak extra memory "
              f"{step_mib if step_mib is None else round(step_mib, 1)} MiB; one step on "
              f"B={cfg['check_batch']} x {cfg['check_s']:g} s vs the CPU ({chk['cpu_s']:.2f} s "
              f"there), {_step_check_line(chk)}; {train_bf16_line(b16t, cfg, audio_s)}; {smi}",
              flush=True)
        del cpu
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return stats


def phase_optim_zoo(device, cfg, smi, cases=None) -> dict:
    """Phase 19 (a): each optax name of the JAX factory through the port's
    ``make_optimizer`` over ``cfg["optim_model"]``'s full-width parameters:
    three steps of seeded float64 gradients, clipped by the step's
    ``clip_by_global_norm`` (set to fire on the second), the LR changed
    after the first. The card in float64 against the CPU in float64, the
    card in float32 by the form of phase 10's rule, and the step's time in
    float32 on the card. ``cases`` ((label, name, keywords), default each
    name with none) is phase 21 (b)'s way in; where a keyword stores a
    moment in a narrower dtype, the float32 bound is at least one unit in
    the last place of that dtype (``torch.finfo(dtype).eps``) of max|Δp64|:
    the card's and the CPU's float32 moments round to neighbouring values
    at a few elements, each moving that element's update by up to one
    such unit. Returns each case's readings."""
    import torch

    from sonicsim_tpu_torch.models import get
    from sonicsim_tpu_torch.train import make_optimizer, set_learning_rate
    from sonicsim_tpu_torch.train.trainer import clip_by_global_norm

    name = cfg["optim_model"]
    args = cfg["models"][name]
    weights = seeded_zoo(name, args, cfg["seed"]).state_dict()
    shapes = {n: tuple(p.shape) for n, p in get(name)(**args, device="cpu").named_parameters()
              if p.requires_grad}
    rng = np.random.default_rng(cfg["seed"] + 1)
    grads = [{n: scale * rng.standard_normal(sh) for n, sh in shapes.items()}
             for scale in (1.0, 10.0, 1.0)]
    norms = sorted(float(np.sqrt(sum(np.sum(g * g) for g in tree.values()))) for tree in grads)
    clip = float(np.sqrt(norms[1] * norms[2]))
    p0 = {n: weights[n].double() for n in shapes}
    cpu = torch.device("cpu")

    def run(opt_name, keywords, dev, dtype, timed=False):
        model = get(name)(**args, device=dev).to(dtype)
        model.load_state_dict(weights)
        opt = make_optimizer(model, cfg["lr"], cfg["weight_decay"], opt_name, **keywords)
        params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        for k, tree in enumerate(grads):
            for n, p in params.items():
                p.grad = torch.from_numpy(tree[n]).to(dev, dtype)
            clip_by_global_norm([p.grad for p in params.values()], clip)
            opt.step()
            if k == 0:
                set_learning_rate(opt, cfg["lr2"])
        out = {n: p.detach().double().cpu() for n, p in params.items()}
        ms = median_ms(opt.step, dev, reps=cfg["reps"], warmup=cfg["warmup"]) if timed else None
        return out, ms, type(opt).__name__

    def dist(a, b):
        return max(float((a[n] - b[n]).abs().max()) for n in a)

    stats = {}
    if cases is None:
        cases = [(n, n, {}) for n in cfg.get("names", OPTIM_NAMES)]
    for label, opt_name, keywords in cases:
        c64, _, cls = run(opt_name, keywords, cpu, torch.float64)
        d64, _, _ = run(opt_name, keywords, device, torch.float64)
        c32, _, _ = run(opt_name, keywords, cpu, torch.float32)
        d32, ms, _ = run(opt_name, keywords, device, torch.float32, timed=True)
        moved = dist(c64, p0)
        e64, e32, cpu32 = dist(d64, c64) / moved, dist(d32, c64) / moved, dist(c32, c64) / moved
        stored = max((torch.finfo(getattr(torch, v)).eps for k, v in keywords.items()
                      if k in MOMENT_DTYPES), default=0.0)
        bound = max(OPT_F32_REL, ILL_FACTOR * cpu32, stored)
        check(moved > 0 and e64 <= OPT_F64_REL,
              f"{label}: float64 on the device {e64}·max|Δp64| from the CPU (tol "
              f"{OPT_F64_REL}; max|Δp64| {moved})")
        check(e32 <= bound, f"{label}: float32 on the device {e32}·max|Δp64| from float64 on "
              f"the CPU, over {bound} (the CPU's float32 {cpu32})")
        stats[label] = dict(cls=cls, moved=moved, f64=e64, f32=e32, cpu_f32=cpu32, ms=ms)
        print(f"optim[{label} ({cls})]: {name} at full width, {args['layer']} layers, "
              f"{sum(int(np.prod(s)) for s in shapes.values())} trained parameters, 3 steps "
              f"of seeded gradients (clip {clip:.4g} fires on the second; lr {cfg['lr']} then "
              f"{cfg['lr2']}; weight decay {cfg['weight_decay']}): max|Δp64| {moved:.4g}; "
              f"float64 on the device {e64:.3g}·max|Δp64| from the CPU (tol {OPT_F64_REL}), "
              f"float32 {e32:.3g} (tol {bound:.3g}: max({OPT_F32_REL}, {ILL_FACTOR} x the "
              f"CPU's float32 {cpu32:.3g}"
              + (f", the stored moment's ulp {stored:.3g}" if stored else "")
              + f")); optimizer step {ms:.4f} ms in float32 (CUDA-event median of "
              f"{cfg['reps']} after {cfg['warmup']}); {smi}", flush=True)
    return stats


def phase_remix_fit(device, cfg, folders, root: Path, smi) -> dict:
    """Phase 19 (b): remix training sample directories (``s{i}.wav`` from
    phase 8's ``moving_audio_{i}.wav``, ``noise.wav`` from its
    ``noise_audio.wav``), their segment manifest, and a ``Trainer.fit`` of
    ``cfg["fit_model"]`` with ``cfg["fit_optimizer"]`` on
    ``RemixTrainDataset`` items, each stage timed by ``StageTimer``."""
    import torch

    from sonicsim_tpu_torch.dataset import RemixTrainDataset, build_segment_manifest
    from sonicsim_tpu_torch.scripts.common import strict_float32
    from sonicsim_tpu_torch.train import Trainer
    from sonicsim_tpu_torch.utils import StageTimer

    strict_float32()
    timer = StageTimer()
    tree = root / "remix"
    with timer.stage("remix sample dirs"):
        for i, f in enumerate(folders):
            leaf = tree / f"sample{i}"
            leaf.mkdir(parents=True)
            for src in sorted(f.glob("moving_audio_*.wav")):
                shutil.copyfile(src, leaf / f"s{src.stem.rsplit('_', 1)[1]}.wav")
            shutil.copyfile(f / "noise_audio.wav", leaf / "noise.wav")
    with timer.stage("build_segment_manifest"):
        manifest = build_segment_manifest(tree, root / "segments.json", duration=cfg["remix_s"])
    spans = sum(len(v) for v in manifest.values())
    check(spans > 0, f"the segment manifest has no span: {manifest}")
    ds = RemixTrainDataset(str(root / "segments.json"), duration=cfg["remix_s"],
                           num_samples=cfg["fit_samples"], num_spks=1, seed=cfg["seed"])

    def batches(epoch):
        ds.set_epoch(epoch)
        for i in range(0, len(ds), cfg["batch"]):
            with timer.stage("remix batch"):
                items = [ds[j] for j in range(i, min(i + cfg["batch"], len(ds)))]
                batch = np.stack([m for m, _ in items]), np.stack([t for _, t in items])
            yield batch

    name, args = cfg["enh_models"][cfg["fit_model"]]
    model = seeded_zoo(name, args, cfg["seed"]).to(device)
    loss_node = cfg["losses"][cfg["fit_model"]][0]
    trainer = Trainer(model=model, loss_fn=_instantiate_loss(loss_node), lr=cfg["lr"],
                      max_epochs=cfg["fit_epochs"], exp_dir=root / "exp",
                      optimizer_name=cfg["fit_optimizer"], save_top_k=1)
    with timer.stage("Trainer.fit"):
        state = trainer.fit(batches)
        sync(device)
    records = [json.loads(ln) for ln in (root / "exp" / "metrics.jsonl").read_text().splitlines()]
    check(type(state.optimizer).__name__.lower() == cfg["fit_optimizer"]
          and [r["epoch"] for r in records] == list(range(cfg["fit_epochs"]))
          and all(np.isfinite(r["train_loss"]) for r in records)
          and all(p.device.type == device.type for p in model.parameters()),
          f"remix fit: {type(state.optimizer).__name__}, metrics.jsonl {records}")
    print(f"remix-fit[{cfg['fit_model']}: {name}, {cfg['fit_optimizer']}]: {len(manifest)} "
          f"sample dirs from phase 8's split, {spans} spans of {cfg['remix_s']:g} s in the "
          f"manifest; {cfg['fit_samples']} RemixTrainDataset items per epoch, batch "
          f"{cfg['batch']}, {loss_node[0]}, lr {cfg['lr']}: train loss "
          f"{[round(r['train_loss'], 4) for r in records]}, s/epoch "
          f"{[round(r['seconds'], 3) for r in records]}; {smi}; StageTimer:\n{timer.report()}",
          flush=True)
    del model, trainer, state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(spans=spans, stages=timer.summary(), records=records)


def phase_bank_import(device, banks, ways, static, cfg, root: Path) -> dict:
    """Phase 19 (c): phase 6's banks written as a reference-style
    ``rir_save_*.pt`` (a list of (P, 1, C, L) tensors), converted by
    ``python -m sonicsim_tpu_torch.scripts.import_rir_banks``'s ``main``,
    each ``.npz`` loaded by ``BankRirOracle``, and phase 7's mixture step
    over the loaded banks on the card: equal to phase 7's over phase 6's."""
    import torch

    from sonicsim_tpu_torch.scripts import import_rir_banks
    from sonicsim_tpu_torch.sim import BankRirOracle, ChannelModel

    sample = root / "set" / "scene" / "mixture"
    sample.mkdir(parents=True)
    torch.save([b.cpu() for b in banks], sample / "rir_save_train_Binaural.pt")
    t0 = time.perf_counter()
    n = import_rir_banks.main(["--sonicset_root", str(root / "set"),
                               "--out_root", str(root / "banks")])
    convert_s = time.perf_counter() - t0
    check(n == len(banks), f"import_rir_banks converted {n} banks of {len(banks)}")
    loaded = []
    for i, bank in enumerate(banks):
        oracle = BankRirOracle(root / "banks" / "scene" / "mixture" /
                               f"rir_save_train_Binaural_spk{i + 1}.npz")
        ir = oracle.render(np.zeros(3), np.zeros(3), ChannelModel("Binaural"))
        check(np.array_equal(ir, bank[0, 0].cpu().numpy()), f"bank {i}: the oracle's IR differs")
        loaded.append(torch.from_numpy(oracle._data["rirs"]).to(device))
    check(all(torch.equal(a, b) for a, b in zip(loaded, banks)), "the imported banks differ")
    ref_step = bank_mixture_step(device, banks, ways, static, cfg)[0]
    step, padded = bank_mixture_step(device, loaded, ways, static, cfg)
    for weights_form in (False, True):
        want, got = ref_step(weights_form), step(weights_form)
        sync(device)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"the mixture step over the imported banks differs from phase 7's "
              f"({'weights=' if weights_form else 'fused'} form)")
    print(f"bank-import: phase 6's {len(banks)} banks {tuple(banks[0].shape)} as "
          f"rir_save_train_Binaural.pt -> import_rir_banks ({convert_s:.3f} s) -> "
          f"BankRirOracle, bit-equal to phase 6's; phase 7's mixture step over them "
          f"({padded}), fused and weights= forms, bit-equal to phase 7's over phase 6's",
          flush=True)
    return dict(banks=n, convert_s=convert_s)


def _mesh_render(device, mesh, cfg, mix_cfg, counted) -> dict:
    """Phase 20 (a): the mixture step at the headline's shapes, each form
    sharded and not; inputs uploaded once."""
    import torch

    from sonicsim_tpu_torch.parallel import render_mixture_sources

    lufs = tuple(-17.0 - 0.25 * i for i in range(cfg["n_src"]))
    inp = mixture_inputs(dict(mix_cfg, speech_lufs=lufs))
    up = {k: torch.from_numpy(inp[k]).to(device) for k in ("speech", "banks", "weights",
                                                            "static_audio", "static_rirs")}
    out = {}
    for form in ("fused", "weights"):
        args = (up["speech"], up["banks"], up["weights"] if form == "weights" else None,
                inp["offsets"], inp["lengths"], inp["max_seg"], up["static_audio"],
                up["static_rirs"], inp["speech_lufs"], inp["static_lufs"], SR)

        def one(args=args):
            return render_mixture_sources(*args, device=device)

        def sharded(args=args):
            return render_mixture_sources(*args, mesh=mesh)

        want = one()
        got = counted(sharded)
        check(all(bool(torch.isfinite(g).all()) for g in got), f"mesh render ({form}) not finite")
        check(all(g.shape == w.shape and g.device == w.device for g, w in zip(got, want)),
              f"mesh render ({form}): shapes or devices differ")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(err <= MESH_ATOL, f"mesh render ({form}) vs unsharded: max abs err {err}")
        out[form] = dict(err=err, ms=median_ms(sharded, device, cfg["iters"], 1),
                         one_ms=median_ms(one, device, cfg["iters"], 1))
    return out


def _mesh_banks(device, mesh, cfg, bank_cfg, counted) -> dict:
    """Phase 20 (b): phase 6's three banks in one render over the mesh."""
    import torch

    from sonicsim_tpu_torch.parallel.mesh import shard_slices
    from sonicsim_tpu_torch.sim import render_rir_banks

    oracle, channel = bank_scene(bank_cfg, device=device)
    mic = [np.asarray(bank_cfg["receiver"], np.float64)]
    ways = [bank_ways(k, bank_cfg["n_ways"]) for k in range(bank_cfg["n_banks"])]

    def one():
        return render_rir_banks(oracle, ways, mic, channel, out_device=True)

    def sharded():
        return render_rir_banks(oracle, ways, mic, channel, out_device=True, mesh=mesh)

    want = one()
    got = counted(sharded)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    peaks = [float(g.abs().max()) for g in got]
    check(err <= MESH_ATOL, f"mesh banks vs unsharded: max abs err {err}")
    check(all(abs(p - 1.0) <= MESH_ATOL for p in peaks), f"mesh banks' peaks {peaks}")
    check(all(bool(torch.isfinite(g).all()) for g in got), "mesh banks not finite")
    # which banks lie across two shards of the item axis
    per_item = channel.count * len(mic)
    bounds = np.cumsum([0] + [len(w) * per_item for w in ways])
    cuts = [sl.start for _, sl in shard_slices(int(bounds[-1]), mesh)][1:]
    across = [k for k in range(len(ways)) if any(bounds[k] < c < bounds[k + 1] for c in cuts)]
    check(bool(across), f"no bank lies across the shards (cuts at {cuts})")
    return dict(err=err, across=across, items=int(bounds[-1]),
                s=_host_median_s(lambda: (sharded(), sync(device)), cfg["iters"]),
                one_s=_host_median_s(lambda: (one(), sync(device)), cfg["iters"]))


def _mesh_generation(device, mesh, gen, folder: Path, root: Path, counted) -> dict:
    """Phase 20 (c): phase 8's first mixture again, through render_mixture
    with and without the mesh, on each sink."""
    import torch

    from sonicsim_tpu_torch.bridge import plan_from_json
    from sonicsim_tpu_torch.dataset import render_mixture
    from sonicsim_tpu_torch.utils import read_wav

    plan = plan_from_json(folder / "mixture_plan.json")
    scene = gen["factory"](folder.parent.name)
    out = {}
    for sink in ("disk", "device"):
        runs = {}
        for label, m in (("one", None), ("mesh", mesh)):
            dest = root / f"{sink}_{label}"
            t0 = time.perf_counter()
            if m is None:
                meta = render_mixture(scene, plan, dest, save_trace=False, sink=sink)
            else:
                meta = counted(lambda dest=dest: render_mixture(
                    scene, plan, dest, save_trace=False, sink=sink, mesh=m))
            sync(device)
            runs[label] = (meta, time.perf_counter() - t0)
        if sink == "disk":
            names = _track_names(len(plan.speech_plans))
            err = max(float(np.abs(read_wav(root / "disk_mesh" / n)[0]
                                   - read_wav(root / "disk_one" / n)[0]).max()) for n in names)
            check(err <= MESH_PCM, f"mesh generation (disk): WAVs differ by {err * 32768} steps")
        else:
            a, b = (runs[k][0]["tracks"] for k in ("mesh", "one"))
            err = float((a.to(torch.float32) - b.to(torch.float32)).abs().max())
            if b.dtype == torch.int16:
                err /= 32768.0
            check(a.shape == b.shape and err <= MESH_PCM,
                  f"mesh generation (device): tracks differ by {err * 32768} steps")
        out[sink] = dict(err_steps=err * 32768, s=runs["mesh"][1], one_s=runs["one"][1])
    return out


def _mesh_chunked(device, mesh, cfg, mix60, counted) -> dict:
    """Phase 20 (d): ``wav_chunk_inference`` of a 60 s mixture, ``batch_size``
    windows per replica, against the unsharded call at ``batch_size`` x the
    replicas."""
    import torch

    from sonicsim_tpu_torch import bridge
    from sonicsim_tpu_torch.infer import wav_chunk_inference
    from sonicsim_tpu_torch.models import ConvTasNet

    x = torch.from_numpy(mix60).to(device)
    kw = dict(cfg["chunk"])
    b = kw.pop("batch_size")
    out = {}
    for stem, (name, args, n_tracks) in cfg["chunk_models"].items():
        if name == "ConvTasNet":
            model = ConvTasNet(**args, device=device).eval()
            weights = seeded_convtasnet(args, cfg["seed"])
            model.load_state_dict(bridge.convtasnet_state_dict(weights))
        else:
            model = seeded_zoo(name, args, cfg["seed"]).to(device)

        def one(model=model, n_tracks=n_tracks):
            return wav_chunk_inference(model, x, SR, batch_size=b * mesh.size, n_tracks=n_tracks,
                                       **kw)

        def sharded(model=model, n_tracks=n_tracks):
            return wav_chunk_inference(model, x, SR, batch_size=b, n_tracks=n_tracks, mesh=mesh,
                                       **kw)

        want = one()
        got = counted(sharded)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"mesh chunked ({stem}): {tuple(got.shape)} not finite or not {tuple(want.shape)}")
        ref = float(want.abs().max())
        err = float((got - want).abs().max())
        check(err <= MESH_CHUNK_REL * ref, f"mesh chunked ({stem}): max abs err {err} of {ref}")
        out[stem] = dict(err_rel=err / ref, ms=median_ms(sharded, device, 2, 0),
                         one_ms=median_ms(one, device, 2, 0))
        del model
    return out


def _grad_dist(a: dict, b: dict) -> float:
    """max |a − b| over every gradient, of max |b| over the tree."""
    g_max = max(float(g.abs().max()) for g in b.values())
    return max(float((a[n].double() - g.double()).abs().max()) for n, g in b.items()) / g_max


def _mesh_training(device, mesh, cfg, folders, counted) -> dict:
    """Phase 20 (e): one data-parallel train step of each model (the loss on
    the gathered outputs, one backward, clip, Adam) against the unsharded
    step from the same weights and batch, in float64 and float32; ms/step of
    each in float32. For the batch-statistics models, the float32 step with
    per-shard statistics, which must miss the float32 bound."""
    import torch

    from sonicsim_tpu_torch import bridge
    from sonicsim_tpu_torch.dataset import MovingDataModule
    from sonicsim_tpu_torch.losses import PairwiseNegSDR, PITLossWrapper
    from sonicsim_tpu_torch.models import ConvTasNet, get
    from sonicsim_tpu_torch.parallel import Mesh, gather
    from sonicsim_tpu_torch.train import make_optimizer, make_train_step

    class PerShard(torch.nn.Module):
        """Each of ``n`` shards through the unsharded model, the outputs
        gathered: the per-shard-statistics step a mesh step must not be."""

        def __init__(self, inner, n):
            super().__init__()
            self.inner, self.n = inner, n

        def forward(self, x):
            return gather([self.inner(s) for s in x.tensor_split(self.n)], x.device)

    split = folders[0].parent.parent
    out = {}
    for stem, (name, args, batch) in cfg["train"].items():
        if name == "ConvTasNet":
            weights = bridge.convtasnet_state_dict(seeded_convtasnet(args, cfg["seed"]))
            loss_fn = PITLossWrapper(PairwiseNegSDR("snr"), pit_from="pw_mtx",
                                     threshold_byloss=False)
            spks = 2
        else:
            weights = seeded_zoo(name, args, cfg["seed"]).state_dict()
            loss_fn = _instantiate_loss(cfg["losses"][stem][0])
            spks = 1
        dm = MovingDataModule(train_dir=str(split), val_dir=str(split), test_dir=str(split),
                              num_spks=spks, duration=cfg["crop_s"], num_samples=batch,
                              batch_size=batch, seed=cfg["seed"])
        mix, tgt = (torch.from_numpy(a).to(device) for a in next(iter(dm.train_batches(0))))

        def fresh(dtype, m, shards=0, name=name, args=args, weights=weights, loss_fn=loss_fn):
            model = (ConvTasNet(**args, device=device) if name == "ConvTasNet"
                     else get(name)(**args, device=device))
            model.load_state_dict(weights)
            model.to(dtype)
            step = make_train_step(PerShard(model, shards) if shards else model, loss_fn,
                                   make_optimizer(model.parameters(), cfg["lr"]),
                                   clip_norm=cfg["clip"], mesh=m)
            return model, step

        # the largest part of the mesh the batch divides, as Trainer.fit takes
        n_dev = max(d for d in range(1, mesh.size + 1) if batch % d == 0)
        sub = Mesh(mesh.devices[:n_dev])
        grads, losses, ms, wall = {}, {}, {}, {}
        runs = [(torch.float64, "one", None), (torch.float64, "mesh", sub),
                (torch.float32, "one", None), (torch.float32, "mesh", sub),
                (torch.float32, "reversed", None), (torch.float32, "doubled", None)]
        # the test's power: the batch-statistics models' per-shard step must
        # miss the float32 bound (ConvTasNet has no batch statistics, and its
        # mean loss over equal shards is the whole batch's)
        if name != "ConvTasNet" and n_dev > 1:
            runs.append((torch.float32, "per_shard", None))
        for dtype, label, m in runs:
            t0 = time.perf_counter()
            model, step = fresh(dtype, m, n_dev if label == "per_shard" else 0)
            x, y = {"reversed": (mix.flip(0), tgt.flip(0)),
                    "doubled": (torch.cat([mix, mix]), torch.cat([tgt, tgt])),
                    }.get(label, (mix, tgt))
            x, y = x.to(dtype), y.to(dtype)
            run = (lambda step=step, x=x, y=y: step(x, y))
            losses[dtype, label] = float(counted(run) if m is not None else run())
            grads[dtype, label] = {n: p.grad.detach().clone()
                                   for n, p in model.named_parameters() if p.grad is not None}
            if dtype == torch.float32 and label in ("one", "mesh"):
                ms[label] = median_ms(run, device, cfg["reps"], cfg["warmup"])
            wall[f"{str(dtype)[6:]} {label}"] = round(time.perf_counter() - t0, 2)
            del model, step
        d64 = _grad_dist(grads[torch.float64, "mesh"], grads[torch.float64, "one"])
        # phase 14's rule, float64 refereeing: the unsharded float32 step's
        # largest distance from it over three roundings of its function (the
        # batch in order, reversed, and each item twice: the mean loss and
        # the batch statistics stay, the kernels see another batch size, as
        # on the shards) sets the sharded float32 step's bound
        f32_vs_64 = max(_grad_dist(grads[torch.float32, k], grads[torch.float64, "one"])
                        for k in ("one", "reversed", "doubled"))
        d32 = _grad_dist(grads[torch.float32, "mesh"], grads[torch.float64, "one"])
        bound = max(TRAIN_GRAD_REL, ILL_FACTOR * f32_vs_64)
        check(all(np.isfinite(v) for v in losses.values()), f"mesh step ({stem}): {losses}")
        check(d64 <= F64_REL, f"mesh step ({stem}) float64 vs unsharded: {d64:.3g} of max|g64|")
        check(d32 <= bound, f"mesh step ({stem}) float32 vs the unsharded float64 step: "
              f"{d32:.3g} of max|g64| (bound {bound:.3g})")
        per_shard = (_grad_dist(grads[torch.float32, "per_shard"], grads[torch.float64, "one"])
                     if (torch.float32, "per_shard") in grads else None)
        if per_shard is not None:
            check(per_shard > bound, f"mesh step ({stem}): the per-shard-statistics step, "
                  f"{per_shard:.3g} of max|g64|, meets the bound {bound:.3g}")
        out[stem] = dict(batch=batch, devices=n_dev, wall=wall, d64=d64, d32=d32, bound=bound,
                         f32_vs_64=f32_vs_64, per_shard=per_shard, ms=ms["mesh"],
                         one_ms=ms["one"],
                         loss_rel=abs(losses[torch.float32, "mesh"] - losses[torch.float32, "one"])
                         / abs(losses[torch.float32, "one"]))
        del grads
    return out


def phase_mesh(device, cfg, mix_cfg, bank_cfg, gen, folders, root: Path, smi):
    """Phase 20: the device mesh. Returns (each mesh's numbers, the kernel
    launches of its sharded render paths, (a)-(c))."""
    import torch

    from sonicsim_tpu_torch.ops import kernels
    from sonicsim_tpu_torch.parallel import Mesh, make_mesh
    from sonicsim_tpu_torch.scripts.common import strict_float32

    strict_float32()
    root.mkdir()
    meshes = {f"{cfg['replicas']} x {device}": Mesh([device] * cfg["replicas"])}
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        meshes[f"make_mesh(): {torch.cuda.device_count()} cards"] = make_mesh()
    launches = dict.fromkeys(kernels.LAUNCHES, 0)

    def counted(fn):
        kernels.reset_launch_counts()
        result = fn()
        sync(device)
        for k, v in kernels.LAUNCHES.items():
            launches[k] += v
        return result

    mix60 = _mono_mixes(folders[:1])[0][: int(cfg["chunk_s"] * SR)]
    stats = {}
    for i, (label, mesh) in enumerate(meshes.items()):
        part_s, mark = {}, [time.perf_counter()]

        def part(name, result, part_s=part_s, mark=mark):
            now = time.perf_counter()
            part_s[name] = round(now - mark[0], 1)
            mark[0] = now
            return result

        render = part("a", _mesh_render(device, mesh, cfg, mix_cfg, counted))
        banks = part("b", _mesh_banks(device, mesh, cfg, bank_cfg, counted))
        generation = part("c", _mesh_generation(device, mesh, gen, folders[0], root / f"gen{i}",
                                                counted))
        paths = dict(launches)
        chunked = part("d", _mesh_chunked(device, mesh, cfg, mix60, counted))
        training = part("e", _mesh_training(device, mesh, cfg, folders, counted))
        check(launches == paths, f"mesh chunked inference or training launched a kernel: "
              f"{launches} against {paths}")
        stats[label] = dict(render=render, banks=banks, generation=generation, chunked=chunked,
                            training=training, seconds=part_s)
        print(f"mesh[{label}] (a) render_mixture_sources, {cfg['n_src']} src x "
              f"{mix_cfg['duration']:g} s + 2 static, {mix_cfg['p']} x {mix_cfg['c']} x "
              f"{mix_cfg['l']} banks: " + "; ".join(
                  f"{k} {v['ms']:.3f} ms sharded vs {v['one_ms']:.3f} unsharded, max abs err "
                  f"{v['err']:.3g}" for k, v in render.items()) + " (medians of "
              f"{cfg['iters']}); (b) phase 6's banks, {banks['items']} items: "
              f"{banks['s'] * 1e3:.2f} ms sharded vs {banks['one_s'] * 1e3:.2f} unsharded (host "
              f"medians), max abs err {banks['err']:.3g}, banks {banks['across']} across the "
              f"shards, peaks 1; (c) phase 8's first mixture: " + "; ".join(
                  f"{k} sink {v['s']:.3f} s sharded vs {v['one_s']:.3f} unsharded, "
                  f"{v['err_steps']:.3g} int16 steps apart" for k, v in generation.items()),
              flush=True)
        print(f"mesh[{label}] (d) wav_chunk_inference, {cfg['chunk_s']:g} s at "
              f"{cfg['chunk']}: " + "; ".join(
                  f"{k} {v['ms']:.2f} ms sharded vs {v['one_ms']:.2f} at batch_size x "
                  f"{mesh.size}, {v['err_rel']:.3g} of max|ref|" for k, v in chunked.items())
              + "; (e) train step, seeded, Adam lr " + f"{cfg['lr']}, clip {cfg['clip']}: "
              + "; ".join(
                  f"{k} B={v['batch']} x {cfg['crop_s']:g} s over {v['devices']} {v['ms']:.2f} "
                  f"ms/step sharded vs "
                  f"{v['one_ms']:.2f} unsharded, float64 {v['d64']:.3g} of max|g64| from the "
                  f"unsharded float64 step, float32 {v['d32']:.3g} (bound {v['bound']:.3g}; the "
                  f"unsharded float32 step's three roundings {v['f32_vs_64']:.3g}; "
                  + ("no batch statistics" if v["per_shard"] is None else
                     f"per-shard statistics {v['per_shard']:.3g}") + "), loss rel "
                  f"{v['loss_rel']:.3g}, host s per run {v['wall']}"
                  for k, v in training.items()) + f"; host seconds of each part {part_s}; {smi}",
              flush=True)
    return stats, launches


def reference_checkpoint(path: Path, name: str, args: dict, seed: int) -> None:
    """A reference ``best_model.pth`` of ``name`` at ``args``: seeded weights
    (:func:`seeded_zoo`; a quirk model built in its reference mode) under
    the reference's parameter names, the constructor's arguments plus the
    reference's bookkeeping ``n_src``; a BatchNorm's running variances
    1 + |drawn|, as a trained one's are positive."""
    import torch

    quirk = {"torch_compat": True} if name in QUIRK_MODELS else {}
    model = seeded_zoo(name, dict(args, **quirk), seed)
    ref_args = {k: v for k, v in model.model_args().items() if k != "torch_compat"}
    sd = {k: 1.0 + v.abs() if k.endswith("running_var") else v
          for k, v in model.state_dict().items()}
    torch.save({"model_name": name, "model_args": dict(ref_args, n_src=2), "state_dict": sd},
               path)


def _rnn_layer_hold(device, label, spec, seed: int, cfg) -> dict:
    """Phase 21 (c): one bf16 recurrent layer (``zoo_layers.recurrent_layer``
    at ``spec``'s widths, seeded) on the card and on the CPU, its state cast
    to bfloat16 and its input bfloat16 (``infer.precision``'s call): rel-L2
    of the card's output from the CPU's, the distance of the float32-input
    call (no rounding) from it, and the bf16 and fp32 forward times."""
    import torch

    from sonicsim_tpu_torch.models.zoo_layers import recurrent_layer

    kind, n_in, hidden, bi, layers, (b, t) = spec
    torch.manual_seed(seed)
    layer = recurrent_layer(kind, n_in, hidden, bi, layers).eval()
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((b, t, n_in),
                                                                     dtype=np.float32))

    def call(mod, inp, dtype):
        state = {n: q.to(dtype) for n, q in mod.named_parameters()}
        with torch.inference_mode():
            return torch.func.functional_call(mod, state, (inp,))

    cpu = call(layer, x.to(torch.bfloat16), torch.bfloat16)
    card_layer = recurrent_layer(kind, n_in, hidden, bi, layers).to(device).eval()
    card_layer.load_state_dict(layer.state_dict())
    xd = x.to(device)
    card = call(card_layer, xd.to(torch.bfloat16), torch.bfloat16).cpu()
    unrounded = call(card_layer, xd, torch.bfloat16).cpu()
    rel = _rel_l2(card, cpu)
    check(card.dtype == torch.float32 and bool(torch.isfinite(card).all()) and rel <= RNN_BF16_REL,
          f"rnn[{label}] bf16 on the card vs the CPU: rel-L2 {rel} (tol {RNN_BF16_REL})")
    rounding = _rel_l2(card, unrounded)
    check(rounding > 0, f"rnn[{label}]: the bf16 input's projection was not rounded")
    ms16 = median_ms(lambda: call(card_layer, xd.to(torch.bfloat16), torch.bfloat16), device,
                     reps=cfg["reps"], warmup=cfg["warmup"])
    with torch.inference_mode():
        ms32 = median_ms(lambda: card_layer(xd), device, reps=cfg["reps"], warmup=cfg["warmup"])
    return dict(rel=rel, rounding=rounding, ms_bf16=ms16, ms_fp32=ms32)


def phase_import_keywords(device, cfg, optim_cfg, folders, root: Path, smi) -> dict:
    """Phase 21: (a) the checkpoint-import CLI, (b) optax's keywords, (c) the
    bf16 recurrent layers (the module docstring's item 21). Returns the
    readings."""
    import torch

    from sonicsim_tpu_torch.models import from_pretrain
    from sonicsim_tpu_torch.scripts import import_checkpoint
    from sonicsim_tpu_torch.scripts.common import make_forward, strict_float32

    strict_float32()
    root.mkdir()
    crop = torch.from_numpy(_mono_mixes(folders[:1])[0][None, :int(cfg["crop_s"] * SR)].copy())
    stats = {"imports": {}, "keywords": {}, "rnn": {}}
    for stem, (name, args) in cfg["imports"].items():
        pth, pkl = root / f"{stem}.pth", root / f"{stem}.pkl"
        reference_checkpoint(pth, name, args, cfg["seed"])
        t0 = time.perf_counter()
        line = import_checkpoint.main(["--in", str(pth), "--out", str(pkl)])
        convert_s = time.perf_counter() - t0
        packed, direct = from_pretrain(pkl, device=device), from_pretrain(pth, device=device)
        check(type(packed).__name__ == name and line == f"imported {name} -> {pkl}",
              f"import {stem}: {line!r}, built {type(packed).__name__}")
        check(packed.model_args() == direct.model_args(),
              f"import {stem}: the pack's model_args {packed.model_args()} are not the .pth's "
              f"{direct.model_args()}")
        a, b = packed.state_dict(), direct.state_dict()
        check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
              f"import {stem}: the pack's weights are not the .pth's")
        # Deterministic cuDNN algorithms: FRCRN's forward amplifies the
        # run-to-run spread of the default ones past the gate.
        cudnn = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            got, ref = (make_forward(m)(crop.to(device)).cpu() for m in (packed, direct))
        finally:
            torch.backends.cudnn.deterministic = cudnn
        err, peak = float((got - ref).abs().max()), float(ref.abs().max())
        check(bool(torch.isfinite(got).all()) and got.shape == ref.shape
              and err <= IMPORT_REL * peak,
              f"import {stem}: the pack's forward vs the .pth's on the card: max abs err {err} "
              f"(max|ref| {peak})")
        stats["imports"][stem] = dict(convert_s=convert_s, err=err, max_ref=peak,
                                      mib=pkl.stat().st_size / 2**20)
        print(f"import[{stem}: {name}]: seeded reference .pth at the config's width "
              f"({sum(q.numel() for q in direct.parameters())} parameters"
              + (", torch_compat" if name in QUIRK_MODELS else "") + f") through python -m "
              f"sonicsim_tpu_torch.scripts.import_checkpoint (on its default device, the card): "
              f"{convert_s:.3f} s, a "
              f"{stats['imports'][stem]['mib']:.1f} MiB pack; the pack and the .pth from "
              f"from_pretrain on {device}: the same weights bit for bit, and on a B=1 x "
              f"{cfg['crop_s']:g} s crop of phase 8's first mixture (cuDNN deterministic) max abs "
              f"err {err:.3g} of max|ref| {peak:.3g} (tol {IMPORT_REL}·max|ref|)"
              f"; {smi}", flush=True)
        del packed, direct
    t0 = time.perf_counter()
    stats["keywords"] = phase_optim_zoo(device, optim_cfg, smi, cases=cfg["keywords"])
    t1 = time.perf_counter()
    for label, spec in cfg["rnn_layers"].items():
        r = _rnn_layer_hold(device, label, spec, cfg["seed"], cfg)
        stats["rnn"][label] = r
        kind, n_in, hidden, bi, layers, (b, t) = spec
        print(f"rnn[{label}]: {'bidirectional ' if bi else ''}{kind}, {layers} layer(s), "
              f"{n_in} -> {hidden}, input ({b}, {t}, {n_in}) in bfloat16 on bfloat16 weights "
              f"(the first layer's input projection rounded as flax's): rel-L2 {r['rel']:.3g} "
              f"from the CPU (tol {RNN_BF16_REL}), {r['rounding']:.3g} from the float32-input "
              f"call; {r['ms_bf16']:.4f} ms in bf16, {r['ms_fp32']:.4f} ms in fp32 (CUDA-event "
              f"median of {cfg['reps']} after {cfg['warmup']}); {smi}", flush=True)
    print(f"phase 21: (b) {t1 - t0:.1f} s, (c) {time.perf_counter() - t1:.1f} s (host wall)",
          flush=True)
    return stats


def run(device, smi, head_cfg=HEADLINE, mix_cfg=MIXTURE, bank_cfg=BANK,
        bank_mix_cfg=BANK_MIXTURE, gen_cfg=GENERATION, serve_cfg=SERVE,
        train_cfg=TRAIN, trace_dir=None, zoo_cfg=ZOO, stream_cfg=STREAMING, enh_cfg=ENH,
        enh_train_cfg=ENH_TRAIN, sep_train_cfg=SEP_TRAIN, eval_cfg=EVAL_SIDECARS,
        sidecar_cfg=SIDECAR_MODELS, variants_cfg=VARIANTS, adapters_cfg=ADAPTERS,
        mesh_cfg=MESH, import_cfg=IMPORT_FWD, env_line: str = "") -> None:
    from sonicsim_tpu_torch.ops import kernels

    seconds, mark = {}, [time.perf_counter()]

    def lap(name: str) -> None:  # host wall of each phase, for the call's budget
        now = time.perf_counter()
        seconds[name] = round(now - mark[0], 1)
        mark[0] = now
        print(f"phase {name}: {seconds[name]} s (host wall)", flush=True)

    head = headline_plan(head_cfg)
    mix = mixture_inputs(mix_cfg)
    times = phase_kernels(device, head, mix, bank_cfg, bank_mix_cfg)
    lap("kernels (3)")

    # The main paths: each one's launches counted from a reset just before
    # it to the read just after.
    counts = {}
    kernels.reset_launch_counts()
    phase_headline(device, head, head_cfg)
    counts["headline"] = dict(kernels.LAUNCHES)
    lap("headline (4)")
    kernels.reset_launch_counts()
    phase_mixture(device, mix, mix_cfg)
    counts["mixture"] = dict(kernels.LAUNCHES)
    lap("mixture (5)")
    # Phase 1's line again next to phase 6's (ROADMAP C9): the output's head
    # may be cut from a long run's log.
    print(env_line, flush=True)
    banks, ways, static = phase_bank(device, bank_cfg, trace_dir)
    lap("bank (6)")
    kernels.reset_launch_counts()
    phase_bank_mixture(device, banks, ways, static, bank_mix_cfg)
    counts["bank->mixture"] = dict(kernels.LAUNCHES)
    lap("bank->mixture (7)")
    with tempfile.TemporaryDirectory() as tmp:
        gen = prepare_generation(device, gen_cfg, Path(tmp))
        kernels.reset_launch_counts()
        runs = generation_runs(device, gen_cfg, gen)
        counts["generation"] = dict(kernels.LAUNCHES)
        case = check_generation(device, gen_cfg, gen, runs, smi)
        lap("generation (8)")
        kernels.reset_launch_counts()
        phase_serving(device, serve_cfg, runs["disk"]["produced"], Path(tmp) / "serve", smi)
        serving = dict(kernels.LAUNCHES)
        lap("serving (9)")
        kernels.reset_launch_counts()
        phase_training(device, train_cfg, serve_cfg["model"], runs["disk"]["produced"],
                       Path(tmp) / "train", smi)
        training = dict(kernels.LAUNCHES)
        lap("training (10)")
        kernels.reset_launch_counts()
        phase_zoo(device, zoo_cfg, runs["disk"]["produced"], Path(tmp) / "zoo", smi)
        zoo = dict(kernels.LAUNCHES)
        lap("zoo (11)")
        kernels.reset_launch_counts()
        phase_streaming(device, stream_cfg, runs["disk"]["produced"], Path(tmp) / "stream", smi)
        streaming = dict(kernels.LAUNCHES)
        lap("streaming (12)")
        kernels.reset_launch_counts()
        phase_enhancement(device, enh_cfg, runs["disk"]["produced"], Path(tmp) / "enh", smi)
        enhancement = dict(kernels.LAUNCHES)
        lap("enhancement (13)")
        kernels.reset_launch_counts()
        phase_enh_training(device, enh_train_cfg, enh_cfg["models"], runs["disk"]["produced"],
                           Path(tmp) / "enh_train", smi)
        enh_training = dict(kernels.LAUNCHES)
        lap("enhancement training (14)")
        kernels.reset_launch_counts()
        phase_sep_training(device, sep_train_cfg, runs["disk"]["produced"], smi)
        sep_training = dict(kernels.LAUNCHES)
        lap("separation training (15)")
        kernels.reset_launch_counts()
        phase_eval_sidecars(device, eval_cfg, runs["disk"]["produced"], Path(tmp) / "eval", smi)
        eval_sidecars = dict(kernels.LAUNCHES)
        lap("evaluation sidecars (16)")
        kernels.reset_launch_counts()
        phase_sidecar_models(device, sidecar_cfg, runs["disk"]["produced"],
                             Path(tmp) / "sidecars", Path(tmp) / "serve" / "convtasnet.pkl", smi)
        sidecar_models = dict(kernels.LAUNCHES)
        lap("sidecar models (17)")
        kernels.reset_launch_counts()
        phase_variants(device, variants_cfg, runs["disk"]["produced"], Path(tmp) / "variants",
                       smi)
        variants = dict(kernels.LAUNCHES)
        lap("variants (18)")
        kernels.reset_launch_counts()
        phase_optim_zoo(device, adapters_cfg, smi)
        phase_remix_fit(device, adapters_cfg, runs["disk"]["produced"], Path(tmp) / "remix",
                        smi)
        adapters = dict(kernels.LAUNCHES)
        lap("optimizers, remix fit (19a-b)")
        kernels.reset_launch_counts()
        phase_bank_import(device, banks, ways, static, bank_mix_cfg, Path(tmp) / "bank_import")
        counts["bank import->mixture"] = dict(kernels.LAUNCHES)
        lap("bank import (19c)")
        _, counts["mesh"] = phase_mesh(device, mesh_cfg, mix_cfg, bank_cfg, gen,
                                       runs["disk"]["produced"], Path(tmp) / "mesh", smi)
        lap("mesh (20)")
        kernels.reset_launch_counts()
        phase_import_keywords(device, import_cfg, adapters_cfg, runs["disk"]["produced"],
                              Path(tmp) / "import", smi)
        imports = dict(kernels.LAUNCHES)
        lap("import, optax keywords, bf16 layers (21)")
    for path, c in (("serving", serving), ("training", training), ("the zoo", zoo),
                    ("SkiM streaming", streaming), ("the enhancement zoo", enhancement),
                    ("enhancement training", enh_training),
                    ("separation training", sep_training),
                    ("the evaluation sidecars", eval_sidecars),
                    ("the sidecar models", sidecar_models), ("the variants", variants),
                    ("the optimizers and the remix fit", adapters),
                    ("the import, the optax keywords and the bf16 layers", imports)):
        check(not any(c.values()), f"{path} launched a kernel: {c}")
    times.update(hold_kernel_cases(device, {"generation": case}, first_seed=len(times)))
    launches = {k: sum(c[k] for c in counts.values()) for k in kernels.LAUNCHES}
    if device.type == "cuda":
        for path, c in counts.items():
            check(c["select_segments_ramp"] > 0,
                  f"select_segments (ramp form): no launch in {path}")
        for path in ("mixture", "bank->mixture", "bank import->mixture", "mesh"):
            check(counts[path]["crossfade_combine"] > 0,
                  f"crossfade_combine: no launch in {path}")
    print(f"launches on the main paths: {counts} (the select form is off "
          f"the main paths; the bank render has no kernel of its own; "
          f"generation takes the fused form alone); serving (phase 9) launches "
          f"neither kernel: {serving}, nor does training (phase 10): {training}, nor "
          f"the zoo (phase 11): {zoo}, nor SkiM streaming (phase 12): {streaming}, nor the "
          f"enhancement zoo (phase 13): {enhancement}, nor enhancement training (phase 14): "
          f"{enh_training}, nor separation training (phase 15): {sep_training}, nor the "
          f"evaluation sidecars (phase 16): {eval_sidecars}, nor the sidecar models (phase "
          f"17): {sidecar_models}, nor the variants (phase 18): {variants}, nor the "
          f"optimizers and the remix fit (phase 19a-b): {adapters} (no zoo model, optimizer "
          f"or sidecar has a Pallas counterpart); the imported banks' mixture step (phase "
          f"19c) is phase 7's path; the mesh (phase 20) counts its sharded (a)-(c) alone, and "
          f"its chunked inference and train steps launch neither kernel; nor does phase 21: "
          f"{imports}", flush=True)
    print(f"phase seconds (host wall): {seconds}", flush=True)

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
                  gen_cfg=GENERATION, serve_cfg=SERVE, train_cfg=TRAIN, zoo_cfg=ZOO,
                  reps: int = 10, only: str | None = None):
    """The main paths under ``torch.profiler``: for the headline render, the
    fused mixture step, the RIR-bank render, one generated mixture with
    the disk sink and with the device sink (where the port has
    ``dataset``), ConvTasNet's forward on 60 s in fp32 and on a batch of
    4 s crops in bf16 (where the port has ``models``), its train step in
    fp32 and bf16 (where it has ``train``), and each zoo model's 10 s
    forward in fp32 and bf16 (where it has the zoo), ``reps`` calls after a
    warm-up (``zoo_cfg["profile_reps"]`` for the zoo); with ``only`` (prefixes,
    comma-separated), the paths whose name starts with one of them alone."""
    tmp = Path(tempfile.mkdtemp())
    try:
        _profile_paths(device, head_cfg, mix_cfg, bank_cfg, gen_cfg, serve_cfg, train_cfg,
                       zoo_cfg, reps, tmp, only)
    finally:
        shutil.rmtree(tmp)


def _serving_paths(device, cfg, root: Path) -> dict:
    """ConvTasNet's forward from phase 9's pack, on seeded noise: one 60 s
    mixture in fp32, and ``cfg["batch"]`` crops of ``cfg["crop_s"]`` in
    bf16."""
    import torch

    from sonicsim_tpu_torch.scripts.common import make_forward

    _, model, _ = serving_models(device, cfg, root)
    g = torch.Generator(device=device).manual_seed(cfg["seed"])
    x60 = 0.1 * torch.randn((1, int(60 * SR)), generator=g, device=device)
    xb = 0.1 * torch.randn((cfg["batch"], int(cfg["crop_s"] * SR)), generator=g, device=device)
    fwd32, fwd16 = make_forward(model), make_forward(model, bf16=True)
    return {"serve-fp32-60s": lambda: fwd32(x60), "serve-bf16-B16": lambda: fwd16(xb)}


def _training_paths(device, cfg, model_cfg) -> dict:
    """One full-width train step (phase 10's seeded weights, optimizer,
    clip and loss) on B=``cfg["batch"]`` seeded-noise crops of
    ``cfg["crop_s"]``, in fp32 and in bf16; ``train-optim-…`` with
    ``train.optim.Adam`` (optax's arithmetic, which an ``eps_root`` routes
    to) in place of ``torch.optim.Adam``, the same function."""
    import torch

    from sonicsim_tpu_torch import bridge
    from sonicsim_tpu_torch.losses import PairwiseNegSDR, PITLossWrapper
    from sonicsim_tpu_torch.models import ConvTasNet
    from sonicsim_tpu_torch.train import make_optimizer, make_train_step

    weights = bridge.convtasnet_state_dict(seeded_convtasnet(model_cfg, cfg["seed"]))
    loss_fn = PITLossWrapper(PairwiseNegSDR("snr"), threshold_byloss=False)
    g = torch.Generator(device=device).manual_seed(cfg["seed"])
    n = int(cfg["crop_s"] * SR)
    x = 0.1 * torch.randn((cfg["batch"], n), generator=g, device=device)
    y = 0.1 * torch.randn((cfg["batch"], 2, n), generator=g, device=device)
    paths = {}
    for precision in ("fp32", "bf16"):
        for form, keywords in (("", {}), ("optim-", {"eps_root": 0.0})):
            model = ConvTasNet(**model_cfg, device=device)
            model.load_state_dict(weights)
            step = make_train_step(model, loss_fn,
                                   make_optimizer(model.parameters(), cfg["lr"], **keywords),
                                   "f32" if precision == "fp32" else "bf16", cfg["clip"])
            paths[f"train-{form}{precision}-B{cfg['batch']}"] = lambda step=step: step(x, y)
    return paths


def _forward_paths(device, cfg, prefix: str, models: dict, wanted=lambda name: True) -> dict:
    """Each model's forward (``models``: path stem -> (name, args); phase 11
    and 13's seeded weights) on B=1 x ``cfg["window_s"]`` of seeded noise:
    ``<prefix>-<stem>-<window>s`` in fp32 and, where the port serves the
    model in bf16 (``require_bf16``), ``…-bf16`` in bf16; the models with a
    ``wanted`` path alone are built."""
    import torch

    from sonicsim_tpu_torch.infer.precision import require_bf16
    from sonicsim_tpu_torch.scripts.common import make_forward

    g = torch.Generator(device=device).manual_seed(cfg["seed"])
    x = 0.1 * torch.randn((1, int(cfg["window_s"] * SR)), generator=g, device=device)
    paths = {}
    for stem, (name, args) in models.items():
        path = f"{prefix}-{stem}-{cfg['window_s']:g}s"
        if not (wanted(path) or wanted(path + "-bf16")):
            continue
        model = seeded_zoo(name, args, cfg["seed"])
        model.place(device)
        fwd = make_forward(model)
        paths[path] = lambda fwd=fwd: fwd(x)
        try:
            require_bf16(model)
        except NotImplementedError:
            continue
        fwd16 = make_forward(model, bf16=True)
        paths[path + "-bf16"] = lambda fwd16=fwd16: fwd16(x)
    return paths


def _sep_train_paths(device, cfg, wanted=lambda name: True) -> dict:
    """Each separation config's train step (phase 15's seeded weights,
    optimizer, clip and loss) on B=``cfg["batch"]`` seeded-noise crops of
    ``cfg["crop_s"]``, in fp32; the configs whose path is ``wanted`` alone
    are built."""
    import torch

    g = torch.Generator(device=device).manual_seed(cfg["seed"])
    n = int(cfg["crop_s"] * SR)
    x = 0.1 * torch.randn((cfg["batch"], n), generator=g, device=device)
    y = 0.1 * torch.randn((cfg["batch"], 2, n), generator=g, device=device)
    paths = {}
    for stem, (name, _, _) in cfg["configs"].items():
        path = f"sep-train-{stem}"
        if not wanted(path):
            continue
        weights = seeded_zoo(name, cfg["models"][name], cfg["seed"]).state_dict()
        _, step = sep_train_fresh(stem, weights, cfg)(device)
        paths[path] = lambda step=step: step(x, y)
    return paths


def _generation_paths(device, cfg, root: Path) -> dict:
    """One 60 s mixture of phase 8's corpus, planned from a fixed seed, as
    ``render_mixture`` with the disk sink and with the device sink (a warm
    utterance cache)."""
    from sonicsim_tpu_torch.dataset import (
        UtteranceCache,
        plan_mixture,
        render_mixture,
        scan_audio_lengths,
    )

    dirs, noise, music = generation_corpus(root / "corpus", cfg)
    name = None if device.type == "cuda" else str(device)
    scene = generation_factory(cfg, name)(cfg["scenes"][0])
    plan = plan_mixture(scene, [scan_audio_lengths(d) for d in dirs[:3]], noise, music,
                        np.random.default_rng(cfg["seed"]), duration=cfg["duration"],
                        seed=cfg["seed"])
    cache = UtteranceCache(sample_rate=SR, device=name)
    return {
        "generation-disk": lambda: render_mixture(scene, plan, root / "disk", cache=cache),
        "generation-device": lambda: render_mixture(scene, plan, root / "device",
                                                    cache=cache, sink="device"),
    }


def _profile_paths(device, head_cfg, mix_cfg, bank_cfg, gen_cfg, serve_cfg, train_cfg, zoo_cfg,
                   n_reps, tmp, only=None, enh_cfg=ENH, sep_train_cfg=SEP_TRAIN):
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

    only = tuple(only.split(",")) if only else ()

    def wanted(prefix: str) -> bool:  # a path named ``prefix…`` can match ``only``
        return not only or any(prefix.startswith(o) or o.startswith(prefix) for o in only)

    if importlib.util.find_spec("sonicsim_tpu_torch.dataset") and wanted("generation-"):
        paths.update(_generation_paths(device, gen_cfg, tmp))
    if importlib.util.find_spec("sonicsim_tpu_torch.models") and wanted("serve-"):
        paths.update(_serving_paths(device, serve_cfg, tmp))
    if importlib.util.find_spec("sonicsim_tpu_torch.train") and wanted("train-"):
        paths.update(_training_paths(device, train_cfg, serve_cfg["model"]))
    if importlib.util.find_spec("sonicsim_tpu_torch.models.tfgridnet") and wanted("zoo-"):
        paths.update(_forward_paths(device, zoo_cfg, "zoo", {
            name.lower(): (name, args) for name, args in zoo_cfg["models"].items()}, wanted))
    if importlib.util.find_spec("sonicsim_tpu_torch.models.frcrn") and wanted("enh-"):
        paths.update(_forward_paths(device, enh_cfg, "enh", enh_cfg["models"], wanted))
    if importlib.util.find_spec("sonicsim_tpu_torch.models.tfgridnet") and wanted("sep-train-"):
        paths.update(_sep_train_paths(device, sep_train_cfg, wanted))
    report = {"port": sonicsim_tpu_torch.__file__}
    for name, fn in paths.items():
        if only and not name.startswith(only):  # a tuple: any of the prefixes
            continue
        reps = zoo_cfg["profile_reps"] if name.startswith(("zoo-", "enh-", "sep-")) else n_reps
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
    ap.add_argument("--only", default=None, metavar="PREFIX[,PREFIX…]",
                    help="with --profile, the paths whose name starts with a PREFIX alone")
    ap.add_argument("--port-root", default=None,
                    help="import sonicsim_tpu_torch from this checkout")
    ap.add_argument("--trace-dir", default=None,
                    help="write phase 6's op-by-op trace of the bank (ROADMAP C9) here")
    args = ap.parse_args()
    if args.port_root:
        sys.path.insert(0, args.port_root)
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not importable", file=sys.stderr)
        return 1
    try:
        device, smi, env_line = phase_env()
        phase_build()
        if args.profile:
            phase_profile(device, only=args.only)
            print(smi, flush=True)
        else:
            run(device, smi, trace_dir=args.trace_dir, env_line=env_line)
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
