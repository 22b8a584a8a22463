"""Whisper ASR in PyTorch (port of ``sonicsim_tpu.models.whisper``).

The reference transcribes separated estimates with faster-whisper
(separation/look2hear/metrics/asr.py:3-12) and records the transcript per
eval segment (metrics/wrapper.py:113). The JAX package has that model
natively; this is its port, under HF's parameter names, so an HF or OpenAI
checkpoint loads straight into it:

* :func:`log_mel` — Whisper's log-mel front end (16 kHz, 400-point periodic
  Hann, hop 160, Slaney mel bank, log10 clamped at 1e-10, floor at the
  per-example max − 8, (x + 4)/4) on ``ops/stft.py``;
* :class:`Whisper` — the encoder-decoder transformer (two convolutions and
  sinusoidal positions, learned-position causal decoder with
  cross-attention, output tied to ``embed_tokens``), pre-LN, exact GELU;
* :func:`greedy_decode`, :func:`beam_decode` (HF semantics) and
  :func:`sample_decode` over a KV cache in preallocated buffers, a Python
  loop over positions on the mel's device;
* :func:`load_whisper` — HF directories, OpenAI ``.pt`` files and bare
  state dicts;
* :class:`ByteBpeDecoder` and :func:`make_whisper_transcriber` — the
  tracker's ``extra_text`` contract ``fn(audio, sample_rate) -> str``.

Where the JAX package's decoders run one ``lax.while_loop``, these run a
Python loop that reads one flag back per token (the stop test). Ties in
``beam_decode``'s top-k go to the lower index, as ``jax.lax.top_k`` breaks
them. ``sample_decode`` draws from an explicit ``torch.Generator``: its
stream is not ``jax.random``'s, so the same seed samples other tokens.
"""

from __future__ import annotations

import json
import zlib
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..bridge import float32_tensors, resolve_device
from ..ops.stft import hann_window, stft

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
CHUNK_SAMPLES = 30 * SAMPLE_RATE  # one 30 s decoding window


# ---------------------------------------------------------------------------
# Log-mel front end (openai/whisper audio.py semantics == HF feature extractor)
# ---------------------------------------------------------------------------

def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    mel = 3.0 * f / 200.0
    log_region = f >= 1000.0
    return np.where(
        log_region,
        15.0 + np.log(np.maximum(f, 1e-12) / 1000.0) * (27.0 / np.log(6.4)),
        mel,
    )


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f = 200.0 * m / 3.0
    log_region = m >= 15.0
    return np.where(log_region, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), f)


@lru_cache(maxsize=4)
def mel_filters(n_mels: int, n_fft: int = N_FFT, sample_rate: int = SAMPLE_RATE,
                fmax: float | None = None) -> np.ndarray:
    """(n_fft//2+1, n_mels) Slaney-scale, Slaney-normalised triangles — the
    bank Whisper ships (librosa.filters.mel defaults)."""
    fmax = sample_rate / 2 if fmax is None else fmax
    fft_freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(0.0), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[None, :] - fft_freqs[:, None]  # (F, n_mels+2)
    lower = -ramps[:, :-2] / fdiff[None, :-1]
    upper = ramps[:, 2:] / fdiff[None, 1:]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
    return (weights * enorm[None, :]).astype(np.float32)


def log_mel(wav: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(T,) or (B, T) 16 kHz waveform → (B, n_mels, frames) log-mel features
    on the waveform's device.

    WhisperFeatureExtractor's: the reflect-padded centred STFT, the last
    frame dropped, |·|², the mel projection, log10 clamped at 1e-10, the
    floor at each example's max − 8, then (x + 4)/4. The caller pads or
    trims to 30 s windows (3000 frames) first.
    """
    wav = torch.atleast_2d(wav.to(torch.float32))
    spec = stft(wav, N_FFT, HOP, hann_window(N_FFT, device=wav.device))  # (B, F, frames)
    mag2 = (spec.real ** 2 + spec.imag ** 2)[..., :-1]
    fb = torch.from_numpy(mel_filters(n_mels)).to(wav.device)
    mel = torch.einsum("fm,bft->bmt", fb, mag2)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0


def pad_or_trim(wav: np.ndarray, length: int = CHUNK_SAMPLES) -> np.ndarray:
    wav = np.asarray(wav, np.float32).reshape(-1)
    if len(wav) >= length:
        return wav[:length]
    return np.pad(wav, (0, length - len(wav)))


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int
    n_mels: int
    d_model: int
    encoder_layers: int
    decoder_layers: int
    heads: int
    ffn: int
    max_source_positions: int = 1500
    max_target_positions: int = 448


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's encoder positional table (log-spaced sinusoids)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    angles = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(angles), np.cos(angles)], axis=1).astype(np.float32)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class MHA(nn.Module):
    """Whisper attention: q/v/out biased, k unbiased, q pre-scaled."""

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.d_model, self.heads = d_model, heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.heads, self.d_model // self.heads)

    def attend(self, q, k, v, mask=None) -> torch.Tensor:
        """(B, Tq, H, Dh) × (B, Tk, H, Dh) → (B, Tq, D); q already scaled.
        Masked logits take the dtype's most negative value; the softmax
        runs in float32."""
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out_proj(out.reshape(*out.shape[:2], self.d_model))

    def q_scaled(self, x: torch.Tensor) -> torch.Tensor:
        scale = (self.d_model // self.heads) ** -0.5
        return self._split(self.q_proj(x) * scale)

    def kv(self, x: torch.Tensor):
        return self._split(self.k_proj(x)), self._split(self.v_proj(x))

    def forward(self, x, kv_source=None, mask=None):
        k, v = self.kv(x if kv_source is None else kv_source)
        return self.attend(self.q_scaled(x), k, v, mask)


class WhisperBlock(nn.Module):
    def __init__(self, cfg: WhisperConfig, cross: bool):
        super().__init__()
        self.cross = cross
        d = cfg.d_model
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.self_attn = MHA(d, cfg.heads)
        if cross:
            self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
            self.encoder_attn = MHA(d, cfg.heads)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, cfg.ffn)
        self.fc2 = nn.Linear(cfg.ffn, d)

    def _mlp(self, x):
        return x + self.fc2(_gelu(self.fc1(self.final_layer_norm(x))))

    def forward(self, x, enc=None, self_mask=None):
        x = x + self.self_attn(self.self_attn_layer_norm(x), mask=self_mask)
        if self.cross:
            x = x + self.encoder_attn(self.encoder_attn_layer_norm(x), kv_source=enc)
        return self._mlp(x)

    def step(self, x, pos: int, self_kv, cross_kv):
        """One decode position. x (B, 1, D); ``self_kv`` = (k, v), the
        (B, Tmax, H, Dh) buffers, written at ``pos`` in place; ``cross_kv``
        the precomputed (k, v) over the encoder output. Attends over
        positions ``[0, pos]`` of the buffers (the JAX package masks the
        rest, whose softmax weights are exactly 0)."""
        h = self.self_attn_layer_norm(x)
        k_new, v_new = self.self_attn.kv(h)
        k_buf, v_buf = self_kv
        k_buf[:, pos] = k_new[:, 0]
        v_buf[:, pos] = v_new[:, 0]
        x = x + self.self_attn.attend(self.self_attn.q_scaled(h), k_buf[:, :pos + 1],
                                      v_buf[:, :pos + 1])
        if self.cross:
            h = self.encoder_attn_layer_norm(x)
            x = x + self.encoder_attn.attend(self.encoder_attn.q_scaled(h), *cross_kv)
        return self._mlp(x)

    def cross_cache(self, enc):
        return self.encoder_attn.kv(enc) if self.cross else None


class _Encoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.conv1 = nn.Conv1d(cfg.n_mels, cfg.d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(cfg.d_model, cfg.d_model, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(cfg.max_source_positions, cfg.d_model)
        with torch.no_grad():
            w = self.embed_positions.weight
            w.copy_(torch.from_numpy(sinusoids(*w.shape)).to(w.device))
        self.layers = nn.ModuleList(WhisperBlock(cfg, cross=False)
                                    for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)


class _Decoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.embed_positions = nn.Embedding(cfg.max_target_positions, cfg.d_model)
        self.layers = nn.ModuleList(WhisperBlock(cfg, cross=True)
                                    for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)


class Whisper(nn.Module):
    """HF WhisperForConditionalGeneration's graph (``proj_out`` tied to
    ``decoder.embed_tokens``), under HF's ``encoder.``/``decoder.`` names,
    built on ``device`` (the card unless given)."""

    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.encoder = _Encoder(cfg)
            self.decoder = _Decoder(cfg)

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, frames) → (B, frames//2, D)."""
        e = self.encoder
        x = _gelu(e.conv1(mel))
        x = _gelu(e.conv2(x)).transpose(1, 2)
        x = x + e.embed_positions.weight[None, :x.shape[1]]
        for blk in e.layers:
            x = blk(x)
        return e.layer_norm(x)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder.layer_norm(x) @ self.decoder.embed_tokens.weight.T

    def decode(self, tokens: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        """(B, S) int tokens × encoder output → (B, S, vocab) logits."""
        d = self.decoder
        s = tokens.shape[1]
        x = d.embed_tokens(tokens) + d.embed_positions.weight[None, :s]
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()[None, None]
        for blk in d.layers:
            x = blk(x, enc=enc, self_mask=causal)
        return self._logits(x)

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        return self.decode(tokens, self.encode(mel))

    def init_cache(self, enc: torch.Tensor, max_len: int):
        """Per layer: ((k_self, v_self) zero buffers of (B, max_len, H, Dh),
        (k_cross, v_cross))."""
        c = self.cfg
        shape = (enc.shape[0], max_len, c.heads, c.d_model // c.heads)
        self_kv = [(enc.new_zeros(shape), enc.new_zeros(shape)) for _ in self.decoder.layers]
        cross_kv = [blk.cross_cache(enc) for blk in self.decoder.layers]
        return self_kv, cross_kv

    def decode_step(self, token: torch.Tensor, pos: int, self_kv, cross_kv):
        """token (B,) int at position ``pos`` → ((B, vocab) logits,
        ``self_kv`` written at ``pos``)."""
        d = self.decoder
        x = d.embed_tokens(token[:, None]) + d.embed_positions.weight[None, pos:pos + 1]
        for blk, skv, ckv in zip(d.layers, self_kv, cross_kv):
            x = blk.step(x, pos, skv, ckv)
        return self._logits(x)[:, 0], self_kv


def _suppress(suppress, device) -> torch.Tensor | None:
    return None if suppress is None else torch.as_tensor(
        np.asarray(suppress, bool), device=device)


def _prompt(sot, b: int, max_len: int, eot: int, device) -> torch.Tensor:
    tokens = torch.full((b, max_len), eot, dtype=torch.long, device=device)
    tokens[:, :len(sot)] = torch.as_tensor(np.asarray(sot), dtype=torch.long, device=device)
    return tokens


@torch.inference_mode()
def greedy_decode(model: Whisper, mel: torch.Tensor, sot, eot: int,
                  max_len: int | None = None, suppress=None, stats: dict | None = None
                  ) -> torch.Tensor:
    """Greedy transcription of one mel batch on the mel's device.

    The sot prefix and the generated suffix run through the same cached
    ``decode_step`` (forced tokens while pos + 1 < len(sot)). Returns the
    (B, max_len) token buffer: positions after a row's first ``eot`` repeat
    ``eot``. The loop stops when every row is done, a test that reads one
    flag back per generated token. ``stats``, where given, gets the count
    of decode steps run (``steps``).
    """
    max_len = max_len or model.cfg.max_target_positions
    enc = model.encode(mel)
    self_kv, cross_kv = model.init_cache(enc, max_len)
    b = enc.shape[0]
    tokens = _prompt(sot, b, max_len, eot, mel.device)
    sup = _suppress(suppress, mel.device)
    done = torch.zeros(b, dtype=torch.bool, device=mel.device)
    pos = 0
    while pos + 1 < max_len:
        logits, self_kv = model.decode_step(tokens[:, pos], pos, self_kv, cross_kv)
        pos += 1
        if pos < len(sot):  # forced
            continue
        if sup is not None:
            logits = logits.masked_fill(sup[None], torch.finfo(logits.dtype).min)
        nxt = torch.where(done, eot, logits.argmax(dim=-1))
        tokens[:, pos] = nxt
        done |= nxt == eot
        if bool(done.all()):
            break
    if stats is not None:
        stats["steps"] = pos
    return tokens


def _top_k(x: torch.Tensor, k: int):
    """The ``k`` largest of a 1-D ``x``, ties to the lower index (as
    ``jax.lax.top_k``; ``torch.topk`` orders ties as it likes)."""
    idx = torch.sort(x, descending=True, stable=True).indices[:k]
    return x[idx], idx


@torch.inference_mode()
def beam_decode(model: Whisper, mel: torch.Tensor, sot, eot: int, beam: int = 5,
                max_len: int | None = None, suppress=None, length_penalty: float = 1.0,
                stats: dict | None = None):
    """Beam-search transcription of ONE mel chunk, HF semantics (the JAX
    package's ``beam_decode``): 2·beam continuations per step, eos and
    max-length candidates finalised with score sum_logprobs /
    generated_len**length_penalty, running beams continue until the
    early-stop heuristic (the best attainable running score can no longer
    beat the worst finished one). The stop test reads one flag back per
    step.

    Returns ``(tokens (beam, max_len), scores (beam,))`` sorted best-first;
    positions past a sequence's end repeat ``eot``. With
    length_penalty=1.0, ``scores[0]`` is the best hypothesis' average token
    log-probability (the fallback statistic).
    """
    max_len = max_len or model.cfg.max_target_positions
    prompt_len, k, dev = len(sot), beam, mel.device
    enc = model.encode(mel).repeat_interleave(k, dim=0)  # one beam per row
    self_kv, cross_kv = model.init_cache(enc, max_len)
    sup = _suppress(suppress, dev)
    neg = torch.tensor(-1e9, dtype=torch.float32, device=dev)

    run_seq = _prompt(sot, k, max_len, eot, dev)
    run_scores = torch.full((k,), -1e9, dtype=torch.float32, device=dev)
    run_scores[0] = 0.0
    fin_seq = run_seq.clone()
    fin_scores = torch.full((k,), -1e9, dtype=torch.float32, device=dev)
    fin_done = torch.zeros(k, dtype=torch.bool, device=dev)
    top_mask = torch.arange(2 * k, device=dev) < k  # only top-k ranks may finalise

    # The forced tokens through the cache (the same on every beam); the
    # last prompt position's logits seed the first free step.
    for pos in range(prompt_len - 1):
        _, self_kv = model.decode_step(run_seq[:, pos], pos, self_kv, cross_kv)

    pos = prompt_len - 1
    while pos + 1 < max_len:
        logits, self_kv = model.decode_step(run_seq[:, pos], pos, self_kv, cross_kv)  # (k, V)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        if sup is not None:
            logp = logp.masked_fill(sup[None], -torch.inf)
        v = logp.shape[-1]
        top_scores, top_idx = _top_k((run_scores[:, None] + logp).reshape(-1), 2 * k)
        beam_src = top_idx // v
        tok = top_idx % v
        top_seq = run_seq[beam_src]
        top_seq[:, pos + 1] = tok  # (2k, max_len)
        hits = (tok == eot) | (pos + 2 >= max_len)

        # Running beams: the best k continuations not finished.
        sel_scores, sel = _top_k(top_scores + hits.to(torch.float32) * neg, k)
        run_seq = top_seq[sel]
        src = beam_src[sel]
        self_kv = [(kb[src], vb[src]) for kb, vb in self_kv]

        # Finished set: merge the newly finalised candidates, keep the best k.
        scale = float(pos + 2 - prompt_len) ** length_penalty
        cand = top_scores / scale + (~(hits & top_mask)).to(torch.float32) * neg
        fin_scores, msel = _top_k(torch.cat([fin_scores, cand]), k)
        fin_seq = torch.cat([fin_seq, top_seq])[msel]
        fin_done = torch.cat([fin_done, hits & top_mask])[msel]

        # Early stop: can the best running beam still beat the worst
        # finished hypothesis?
        best_possible = sel_scores[0] / scale
        worst_fin = torch.where(fin_done, fin_scores.min(), neg)
        unsat = (best_possible > worst_fin).any()
        run_scores = sel_scores
        pos += 1
        if not bool(unsat & ~hits.all()):
            break
    if stats is not None:
        stats["steps"] = pos
    return fin_seq, fin_scores


@torch.inference_mode()
def sample_decode(model: Whisper, mel: torch.Tensor, sot, eot: int,
                  generator: torch.Generator, temperature: float,
                  max_len: int | None = None, suppress=None, stats: dict | None = None):
    """Temperature-sampled transcription (the fallback path: at temperature
    > 0 decoding drops to one sampled sequence per row), drawing from
    ``generator`` (on the mel's device) by the Gumbel-max rule.

    Returns ``(tokens (B, max_len), avg_logprob (B,))``: avg_logprob
    averages the sampled tokens' log-probabilities under the suppressed
    softmax (eot included), the statistic the fallback thresholds on.
    """
    max_len = max_len or model.cfg.max_target_positions
    dev = mel.device
    enc = model.encode(mel)
    self_kv, cross_kv = model.init_cache(enc, max_len)
    b = enc.shape[0]
    tokens = _prompt(sot, b, max_len, eot, dev)
    sup = _suppress(suppress, dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    lp_sum = torch.zeros(b, dtype=torch.float32, device=dev)
    n_gen = torch.zeros(b, dtype=torch.int64, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    pos = 0
    while pos + 1 < max_len:
        logits, self_kv = model.decode_step(tokens[:, pos], pos, self_kv, cross_kv)
        pos += 1
        if pos < len(sot):  # forced
            continue
        logits = logits.to(torch.float32)
        if sup is not None:
            logits = logits.masked_fill(sup[None], -torch.inf)
        logp = torch.log_softmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=generator, device=dev).clamp_min(tiny)
        nxt = (logits / max(temperature, 1e-6) - torch.log(-torch.log(u))).argmax(dim=-1)
        nxt = torch.where(done, eot, nxt)
        live = ~done
        lp_sum += torch.where(live, logp.gather(1, nxt[:, None])[:, 0], 0.0)
        n_gen += live.to(torch.int64)
        tokens[:, pos] = nxt
        done |= nxt == eot
        if bool(done.all()):
            break
    if stats is not None:
        stats["steps"] = pos
    return tokens, lp_sum / n_gen.clamp_min(1)


# ---------------------------------------------------------------------------
# Checkpoint import
# ---------------------------------------------------------------------------

_OPENAI_RENAMES = [
    (".attn.query", ".self_attn.q_proj"),
    (".attn.key", ".self_attn.k_proj"),
    (".attn.value", ".self_attn.v_proj"),
    (".attn.out", ".self_attn.out_proj"),
    (".cross_attn.query", ".encoder_attn.q_proj"),
    (".cross_attn.key", ".encoder_attn.k_proj"),
    (".cross_attn.value", ".encoder_attn.v_proj"),
    (".cross_attn.out", ".encoder_attn.out_proj"),
    (".attn_ln", ".self_attn_layer_norm"),
    (".cross_attn_ln", ".encoder_attn_layer_norm"),
    (".mlp_ln", ".final_layer_norm"),
    (".mlp.0", ".fc1"),
    (".mlp.2", ".fc2"),
    (".blocks.", ".layers."),
]


def _normalize_keys(sd: dict) -> dict:
    """OpenAI / HF state-dict naming → HF ``encoder./decoder.`` naming, the
    values as float32 CPU tensors."""
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("model.")
        for old, new in _OPENAI_RENAMES:
            k = k.replace(old, new)
        k = (k.replace("encoder.ln_post", "encoder.layer_norm")
             .replace("decoder.ln.", "decoder.layer_norm.")
             .replace("decoder.token_embedding", "decoder.embed_tokens"))
        if k.endswith("positional_embedding"):  # openai: a raw tensor, no .weight
            k = k.replace("positional_embedding", "embed_positions.weight")
        out[k] = v
    return float32_tensors(out)


def config_from_state_dict(sd: dict, heads: int | None = None) -> WhisperConfig:
    """The architecture from (normalised) weight shapes. ``heads`` defaults
    to d_model/64, true of every released Whisper; ``load_whisper`` reads it
    from dims / config.json instead."""
    d_model, n_mels, _ = sd["encoder.conv1.weight"].shape
    enc_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layers."))
    dec_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("decoder.layers."))
    return WhisperConfig(
        vocab_size=sd["decoder.embed_tokens.weight"].shape[0],
        n_mels=n_mels,
        d_model=d_model,
        encoder_layers=enc_layers,
        decoder_layers=dec_layers,
        heads=heads or max(1, d_model // 64),
        ffn=sd["encoder.layers.0.fc1.weight"].shape[0],
        max_source_positions=sd["encoder.embed_positions.weight"].shape[0],
        max_target_positions=sd["decoder.embed_positions.weight"].shape[0],
    )


def whisper_from_state_dict(sd: dict, heads: int | None = None, device=None) -> Whisper:
    """An HF or OpenAI state dict → the port's :class:`Whisper` on
    ``device`` (the card unless given). HF's ``proj_out.weight`` is the tied
    embedding and is not read; any other unknown or missing key raises."""
    sd = _normalize_keys(sd)
    sd.pop("proj_out.weight", None)
    device = resolve_device(device)
    model = Whisper(config_from_state_dict(sd, heads), device="meta")
    model.load_state_dict(sd, assign=True)  # no initialisation to overwrite
    return model.to(device).eval()


def _read_blob(path: Path):
    if path.suffix == ".safetensors":
        try:
            from safetensors.torch import load_file
        except ImportError:
            raise ImportError(f"{path}: reading it needs the safetensors package") from None
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=False)


def load_whisper(path: str | Path, device=None):
    """A Whisper checkpoint → ``(WhisperConfig, Whisper on device,
    model_dir)``.

    ``path`` may be an OpenAI ``.pt`` file ({"dims", "model_state_dict"}),
    an HF directory (config.json + pytorch_model.bin, or
    model.safetensors), or a bare torch state-dict file.
    """
    path = Path(path)
    heads = None
    if path.is_dir():
        cfg_file = path / "config.json"
        if cfg_file.exists():
            heads = json.loads(cfg_file.read_text()).get("decoder_attention_heads")
        names = [n for n in ("pytorch_model.bin", "whisper.pt", "model.pt", "model.safetensors")
                 if (path / n).exists()]
        if not names:
            raise FileNotFoundError(f"no weight file under {path}")
        blob = _read_blob(path / names[0])
        model_dir = path
    else:
        blob = _read_blob(path)
        model_dir = path.parent
    if isinstance(blob, dict) and "model_state_dict" in blob:
        heads = blob.get("dims", {}).get("n_audio_head", heads)
        blob = blob["model_state_dict"]
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    model = whisper_from_state_dict(blob, heads, device)
    return model.cfg, model, model_dir


# ---------------------------------------------------------------------------
# Detokenizer
# ---------------------------------------------------------------------------

def _byte_decoder() -> dict:
    """Inverse of GPT-2's bytes_to_unicode: printable char → raw byte."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


class ByteBpeDecoder:
    """Decode-only GPT-2 byte-level BPE (Whisper's tokenizer family), built
    from vocab.json (token string → id); special ``<|...|>`` tokens are
    dropped from the text. Transcription never needs the merge table."""

    def __init__(self, vocab: dict[str, int]):
        self.id_to_token = {i: t for t, i in vocab.items()}
        self.byte_dec = _byte_decoder()
        self.specials = {i for t, i in vocab.items() if t.startswith("<|") and t.endswith("|>")}
        self.vocab = vocab

    @classmethod
    def from_dir(cls, model_dir: str | Path) -> "ByteBpeDecoder":
        model_dir = Path(model_dir)
        vocab = json.loads((model_dir / "vocab.json").read_text())
        added = model_dir / "added_tokens.json"
        if added.exists():
            vocab.update(json.loads(added.read_text()))
        return cls(vocab)

    def decode(self, ids) -> str:
        chunks = []
        for i in ids:
            i = int(i)
            if i in self.specials or i not in self.id_to_token:
                continue
            chunks.append(self.id_to_token[i])
        data = bytes(self.byte_dec.get(ch, ord("?") if ord(ch) > 255 else ord(ch))
                     for ch in "".join(chunks))
        return data.decode("utf-8", errors="replace")

    def sot_sequence(self, language: str = "en") -> list[int]:
        """[sot(, lang, transcribe), notimestamps]: the language and task
        tokens only for multilingual vocabularies, told by the released sot
        id (50258; English-only models use 50257)."""
        v = self.vocab
        sot = v["<|startoftranscript|>"]
        seq = [sot]
        multilingual = sot == 50258 or (sot != 50257 and len(v) >= 51865)
        if multilingual and f"<|{language}|>" in v and "<|transcribe|>" in v:
            seq += [v[f"<|{language}|>"], v["<|transcribe|>"]]
        if "<|notimestamps|>" in v:
            seq.append(v["<|notimestamps|>"])
        return seq

    def eot(self) -> int:
        return self.vocab["<|endoftext|>"]

    def suppress_mask(self) -> np.ndarray:
        """Boolean (vocab,) mask: never emit a special but eot."""
        mask = np.zeros(max(self.vocab.values()) + 1, bool)
        for i in self.specials:
            mask[i] = True
        mask[self.eot()] = False
        return mask


# ---------------------------------------------------------------------------
# Transcriber factory (the tracker's extra_text contract)
# ---------------------------------------------------------------------------

def _compression_ratio(text: str) -> float:
    """zlib compression ratio, faster-whisper's repetition detector (above
    ~2.4 the decoder is looping)."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def make_whisper_transcriber(model_path: str | Path, language: str = "en",
                             max_new_tokens: int = 224, beam_size: int | None = None,
                             temperatures=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                             compression_ratio_threshold: float = 2.4,
                             log_prob_threshold: float = -1.0, device=None):
    """``fn(audio, sample_rate) -> str`` over a Whisper checkpoint (HF
    directory or OpenAI .pt, vocab.json beside it) on ``device`` (the card
    unless given): one window per 30 s of audio, the texts joined.

    ``beam_size=None`` decodes greedily; ``beam_size=5`` is faster-whisper's
    default decoder: beam search at temperature 0.0, then per window the
    temperature fallback — where the best hypothesis' average token
    log-probability is below ``log_prob_threshold`` or its text's zlib
    compression ratio above ``compression_ratio_threshold``, the window is
    sampled again at the next temperature. ``fn.stats`` accumulates
    ``windows``, ``steps`` (decode steps run) and ``decodes``.
    """
    cfg, model, model_dir = load_whisper(model_path, device)
    dev = next(model.parameters()).device
    tok = ByteBpeDecoder.from_dir(model_dir)
    sot = np.asarray(tok.sot_sequence(language), np.int64)
    eot = tok.eot()
    suppress = tok.suppress_mask()
    if len(suppress) < cfg.vocab_size:
        # Ids beyond the tokenizer files (the timestamp block) are
        # undecodable: suppress them too.
        suppress = np.pad(suppress, (0, cfg.vocab_size - len(suppress)), constant_values=True)
    sup = suppress[:cfg.vocab_size]
    max_len = min(cfg.max_target_positions, len(sot) + max_new_tokens)
    # 2 mel frames per encoder position (the stride-2 conv); released
    # models: 1500 positions ↔ 3000 frames ↔ 30 s at 16 kHz.
    chunk_samples = 2 * cfg.max_source_positions * HOP
    stats = dict(windows=0, steps=0, decodes=0)

    def _trim(ids) -> str:
        keep = np.asarray(ids.cpu() if torch.is_tensor(ids) else ids)[len(sot):]
        stop = np.nonzero(keep == eot)[0]
        if stop.size:
            keep = keep[:stop[0]]
        return tok.decode(keep).strip()

    def _count(run: dict) -> None:
        stats["steps"] += run["steps"]
        stats["decodes"] += 1

    def _decode_window(chunk: torch.Tensor, seed: int) -> str:
        mel = log_mel(chunk[None], cfg.n_mels)
        run: dict = {}
        if beam_size is None:
            text = _trim(greedy_decode(model, mel, sot, eot, max_len, sup, run)[0])
            _count(run)
            return text
        for t_i, temp in enumerate(temperatures):
            if temp == 0.0:
                seqs, scores = beam_decode(model, mel, sot, eot, beam_size, max_len, sup,
                                           stats=run)
            else:
                gen = torch.Generator(device=dev)
                gen.manual_seed(seed * 1009 + t_i)
                seqs, scores = sample_decode(model, mel, sot, eot, gen, float(temp), max_len,
                                             sup, run)
            _count(run)
            text, avg_lp = _trim(seqs[0]), float(scores[0])
            if avg_lp >= log_prob_threshold and (
                    _compression_ratio(text) <= compression_ratio_threshold):
                return text
        return text  # every temperature failed: keep the last attempt

    def transcribe(audio, sample_rate: int = SAMPLE_RATE) -> str:
        audio = np.asarray(audio, np.float32).reshape(-1)
        if sample_rate != SAMPLE_RATE:
            from ..utils.wavio import resample

            audio = resample(audio, sample_rate, SAMPLE_RATE)
        texts = []
        for w, start in enumerate(range(0, max(len(audio), 1), chunk_samples)):
            chunk = torch.from_numpy(pad_or_trim(audio[start:start + chunk_samples],
                                                 chunk_samples)).to(dev)
            texts.append(_decode_window(chunk, w))
            stats["windows"] += 1
        return " ".join(t for t in texts if t).strip()

    transcribe.stats = stats
    transcribe.model = model
    return transcribe
