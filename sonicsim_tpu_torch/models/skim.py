"""SkiM (skipping-memory LSTM separation) in PyTorch, offline and streaming.

Port of ``sonicsim_tpu.models.skim`` (reference
separation/look2hear/models/skim.py:286-900; config
configs/separation/skim.yaml: 64-dim conv encoder k4/s2, 6 SkiM blocks,
unit 128, segment 250, mem_type hc, seg_overlap, non-causal):
segment-local SegLSTMs whose final (h, c) states are carried across
segments by Mem-LSTMs between blocks. ``SkiMNet`` is the offline forward;
``SkiMStreamer`` runs a causal SkiM one segment at a time
(``forward_stream``, skim.py:603) and drives ``scripts.stream``.

Parameter names are the reference's (``encoder.conv1d``,
``separation.skim.{seg_lstms.{i}.{lstm,proj,norm},mem_lstms.{i}.{h,c}_net.
{rnn,proj},mem_lstms.{i}.{h,c}_norm,output_fc.{0,1}}``, ``decoder``); the
norms keep the reference's ``gamma``/``beta`` of shape (1, C, 1) and compute
the JAX package's norms: GroupNorm(1) (epsilon float32's) when non-causal,
the channel LayerNorm (epsilon 1e-5) when causal. The LSTMs are
``zoo_layers.LSTMLayer`` (one bias per gate in training, ROADMAP C11).

States. torch's LSTM state is ``(h, c)``, each (directions, N, H); flax's
carry is ``(c, h)`` per direction. The Mem-LSTMs read the states as the JAX
package lays them out, (N, directions · H) with the directions side by
side, so both give the same function.
"""

from __future__ import annotations

from collections import deque

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import BaseModel, register_model
from .layers import (Conv1d, ConvTranspose1d, Linear, PReLU, channel_norm_narrow,
                     dense_norm_bf16, float32_or_wider, fused_norm, get_activation,
                     group_norm, promote)
from .zoo_layers import F32_EPS, LSTMLayer, overlap_add_sequence, segment_sequence


class SkiMNorm(nn.Module):
    """The reference's gLN/cLN on channel-last (B, ..., C): ``gamma`` and
    ``beta`` (1, C, 1). Non-causal: GroupNorm(1) over every non-batch axis;
    causal: LayerNorm over the channels."""

    def __init__(self, dim: int, causal: bool):
        super().__init__()
        self.causal = causal
        self.gamma = nn.Parameter(torch.ones(1, dim, 1))
        self.beta = nn.Parameter(torch.zeros(1, dim, 1))

    def forward(self, x: torch.Tensor, unrounded: torch.Tensor | None = None) -> torch.Tensor:
        """``unrounded``, where given, is the float32 value a narrower ``x``
        was rounded from, which XLA fuses into the norm: GroupNorm(1)
        normalises it with ``x``'s statistics (``layers.fused_norm``), the
        cLN's mean reads it (``layers.channel_norm_narrow``)."""
        g, b = self.gamma.reshape(-1), self.beta.reshape(-1)
        if self.causal:  # the JAX cLN, in the promoted dtype
            x, g, b = promote(x, g, b)
            if float32_or_wider(x.dtype) != x.dtype:
                return channel_norm_narrow(x, unrounded, g, b, 1e-5)
            return F.layer_norm(x, (x.shape[-1],), g, b, 1e-5)
        if unrounded is not None:
            return fused_norm(x, unrounded, tuple(range(1, x.dim())), g, b, F32_EPS)
        return group_norm(x.movedim(-1, 1), 1, g, b, F32_EPS).movedim(1, -1)

    def after(self, dense: Linear, x: torch.Tensor) -> torch.Tensor:
        """``self(dense(x))`` as XLA compiles the pair: the norm reads the
        Dense's float32 sum where it rounds (:meth:`forward`); with every
        operand bfloat16, forward and backward are ``jax.vjp``'s
        (``layers.dense_norm_bf16``)."""
        operands = (x, dense.weight, dense.bias, self.gamma, self.beta)
        if all(t.dtype == torch.bfloat16 for t in operands):
            return dense_norm_bf16(x, dense.weight, dense.bias, self.gamma.reshape(-1),
                                   self.beta.reshape(-1), 1e-5 if self.causal else F32_EPS,
                                   self.causal)
        return self(dense(x), dense.unrounded(x))


def _flat_states(s: torch.Tensor) -> torch.Tensor:
    """(directions, N, H) → (N, directions · H), the JAX package's layout."""
    return s.transpose(0, 1).reshape(s.shape[1], -1)


def _split_states(s: torch.Tensor, dirs: int) -> torch.Tensor:
    """The inverse of :func:`_flat_states`."""
    return s.reshape(s.shape[0], dirs, -1).transpose(0, 1).contiguous()


class SegLSTM(nn.Module):
    """An LSTM over each segment from injected initial states, a projection
    and a residual norm (skim.py:418-476): ``lstm``, ``proj``, ``norm``."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool, causal: bool):
        super().__init__()
        self.lstm = LSTMLayer(input_size, hidden_size, bidirectional)
        self.proj = Linear(hidden_size * (2 if bidirectional else 1), input_size)
        self.norm = SkiMNorm(input_size, causal)

    def forward(self, x: torch.Tensor, hc=None, wide: torch.Tensor | None = None,
                wide_out: list | None = None):
        """(N, K, D) and ``(h, c)`` (or None: zeros) → (N, K, D), final
        ``(h, c)``.

        Below float32 this follows XLA's compiled JAX SegLSTM, which fuses
        across the block: the norm's statistics read the rounded projection
        and its normalisation the float32 sum of the rounded product and
        the bias; a residual that promotes ``x`` to float32 reads ``wide``,
        the float32 value ``x`` was rounded from (the previous block's sum,
        fused in), where the caller gives it. Where the output is rounded,
        the float32 sum it was rounded from is appended to ``wide_out``."""
        if hc is None:  # zeros in the input's dtype, as the JAX SegLSTM makes them
            lstm = self.lstm
            zeros = x.new_zeros(2 if lstm.bidirectional else 1, x.shape[0], lstm.hidden_size)
            hc = (zeros, zeros)
        out, hc = self.lstm.run(x, hc)
        n = self.norm.after(self.proj, out)
        if wide is not None and torch.promote_types(x.dtype, n.dtype) != x.dtype:
            return wide.to(n.dtype) + n, hc
        out = x + n
        if wide_out is not None and float32_or_wider(out.dtype) != out.dtype:
            wide_out.append(x.float() + n.float())
        return out, hc


class MemNet(nn.Module):
    """SingleLSTM (skim.py:15-59): an LSTM and a projection back to d·H."""

    def __init__(self, width: int, hidden: int, bidirectional: bool):
        super().__init__()
        self.rnn = LSTMLayer(width, hidden, bidirectional)
        self.proj = Linear(hidden * (2 if bidirectional else 1), width)


class MemLSTM(nn.Module):
    """Refines each segment's final (h, c) across the segment axis with
    residual LSTMs (skim.py:286-389): ``{h,c}_net``, ``{h,c}_norm`` for the
    states that ``mem_type`` keeps ("hc", "h", "c"; "id" passes them on)."""

    def __init__(self, hidden: int, bidirectional: bool, mem_type: str, causal: bool):
        super().__init__()
        self.hidden, self.bidirectional, self.mem_type = hidden, bidirectional, mem_type
        width = hidden * (2 if bidirectional else 1)
        for tag in "hc":
            if mem_type in ("hc", tag):
                self.add_module(f"{tag}_net", MemNet(width, hidden, bidirectional))
                self.add_module(f"{tag}_norm", SkiMNorm(width, causal))

    def across(self, tag: str, x: torch.Tensor) -> torch.Tensor:
        net = getattr(self, f"{tag}_net")
        return x + getattr(self, f"{tag}_norm")(net.proj(net.rnn(x)))

    def forward(self, hc, n_seg: int):
        if self.mem_type == "id":
            return hc
        h, c = hc
        dirs = h.shape[0]
        hs, cs = _flat_states(h), _flat_states(c)
        bs = hs.shape[0] // n_seg
        hs, cs = hs.reshape(bs, n_seg, -1), cs.reshape(bs, n_seg, -1)
        hs = self.across("h", hs) if self.mem_type in ("hc", "h") else torch.zeros_like(hs)
        cs = self.across("c", cs) if self.mem_type in ("hc", "c") else torch.zeros_like(cs)
        if not self.bidirectional:
            # Causal shift (skim.py:378-387): segment p starts from the state
            # refined after segment p − 1; segment 0 from zeros.
            hs = F.pad(hs, (0, 0, 1, 0))[:, :-1]
            cs = F.pad(cs, (0, 0, 1, 0))[:, :-1]
        return (_split_states(hs.reshape(bs * n_seg, -1), dirs),
                _split_states(cs.reshape(bs * n_seg, -1), dirs))


class _Encoder(nn.Module):
    def __init__(self, dim: int, k: int):
        super().__init__()
        self.conv1d = Conv1d(1, dim, k, stride=k // 2, bias=False)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # (B, n) → (B, T', D)
        return torch.relu(self.conv1d(wav[:, None, :])).transpose(1, 2)


class _SkiM(nn.Module):
    def __init__(self, dim: int, unit: int, layers: int, spks: int, causal: bool,
                 mem_type: str):
        super().__init__()
        bidirectional = not causal
        self.seg_lstms = nn.ModuleList(SegLSTM(dim, unit, bidirectional, causal)
                                       for _ in range(layers))
        self.mem_lstms = nn.ModuleList(
            MemLSTM(unit, bidirectional, mem_type, causal)
            for _ in range(layers - 1 if mem_type else 0))
        self.output_fc = nn.Sequential(PReLU(), Conv1d(dim, dim * spks, 1))


class _Separation(nn.Module):
    def __init__(self, **kwargs):
        super().__init__()
        self.skim = _SkiM(**kwargs)


@register_model
class SkiMNet(BaseModel):
    """Keyword names are the JAX package's fields (skim.yaml). ``dropout``
    is kept and never applied, as in the JAX package. Built on ``device``:
    the card unless the caller names another."""

    def __init__(self, input_dim: int = 64, causal: bool = False, num_spk: int = 2,
                 nonlinear: str = "relu", layer: int = 6, unit: int = 128,
                 segment_size: int = 250, dropout: float = 0.1, mem_type: str = "hc",
                 seg_overlap: bool = True, kernel_size: int = 4, sample_rate: int = 16000, *,
                 device=None):
        super().__init__(dict(input_dim=input_dim, causal=causal, num_spk=num_spk,
                              nonlinear=nonlinear, layer=layer, unit=unit,
                              segment_size=segment_size, dropout=dropout, mem_type=mem_type,
                              seg_overlap=seg_overlap, kernel_size=kernel_size,
                              sample_rate=sample_rate))
        self.input_dim, self.causal, self.num_spk = input_dim, causal, num_spk
        self.nonlinear, self.layer, self.unit = nonlinear, layer, unit
        self.segment_size, self.mem_type, self.seg_overlap = segment_size, mem_type, seg_overlap
        self.kernel_size, self.sample_rate = kernel_size, sample_rate
        self.encoder = _Encoder(input_dim, kernel_size)
        self.separation = _Separation(dim=input_dim, unit=unit, layers=layer, spks=num_spk,
                                      causal=causal, mem_type=mem_type)
        self.decoder = ConvTranspose1d(input_dim, 1, kernel_size, stride=kernel_size // 2,
                                       bias=False)
        self.place(device)

    def masks(self, out: torch.Tensor) -> torch.Tensor:
        """(B, T', D) blocks' output → (B, D, spks, T') masks (the channel
        axis read as (D, spks), skim.py:751)."""
        sk = self.separation.skim
        m = sk.output_fc(out.transpose(1, 2))  # (B, D·spks, T')
        m = m.reshape(m.shape[0], self.input_dim, self.num_spk, -1)
        return get_activation(self.nonlinear)(m)

    def decode(self, enc: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """(B, T', D) encoder output and its masks → (B·spks, n) samples.
        Reference quirk (skim.py:886-887): the masked features are multiplied
        by the encoder output again, so the decoder reads e² · mask."""
        e = enc.transpose(1, 2)
        masked = (e * e)[:, :, None, :] * masks  # (B, D, spks, T')
        masked = masked.transpose(1, 2).reshape(-1, self.input_dim, masked.shape[-1])
        return self.decoder(masked)[:, 0]

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # (B, T) → (B, spks, T)
        if wav.dim() == 1:
            wav = wav[None, :]
        bsz, nsample = wav.shape
        k = self.segment_size
        enc = self.encoder(wav)  # (B, T', D)
        t_enc = enc.shape[1]
        if self.seg_overlap:
            chunks, gap = segment_sequence(enc, k)  # (B, S, K, D)
        else:
            chunks = F.pad(enc, (0, 0, 0, (-t_enc) % k)).reshape(bsz, -1, k, self.input_dim)
        b, s, _, d = chunks.shape
        sk = self.separation.skim
        out, hc, wide = chunks.reshape(b * s, k, d), None, None
        for i, seg in enumerate(sk.seg_lstms):
            sums = []
            out, hc = seg(out, hc, wide, sums)
            wide = sums[0] if sums else None
            if i < len(sk.mem_lstms):
                hc = sk.mem_lstms[i](hc, s)
        out = out.reshape(b, s, k, d)
        merged = (overlap_add_sequence(out, gap) if self.seg_overlap
                  else out.reshape(b, s * k, d)[:, :t_enc])
        dec = self.decode(enc, self.masks(merged))[:, :nsample]
        dec = F.pad(dec, (0, nsample - dec.shape[-1]))
        return dec.reshape(bsz, self.num_spk, nsample)


class SkiMStreamer:
    """Segment-streaming inference for a causal SkiM (``forward_stream``
    parity, skim.py:603+, at segment granularity).

    Feed raw audio chunks (``chunk_samples`` = ``segment_size · kernel_size
    // 2`` samples gives one segment per call); each call returns the
    separated samples that became ready, (B, spks, m). The streamer carries
    each layer's SegLSTM state, the Mem-LSTMs' own states, the raw samples
    not yet framed, the frames not yet segmented and the decoder's
    overlap-add tail, so the output matches the offline causal forward.
    """

    def __init__(self, model: SkiMNet):
        if not model.causal or model.seg_overlap:
            raise ValueError("streaming requires causal=True, seg_overlap=False")
        if model.mem_type != "hc":
            raise NotImplementedError("streaming supports mem_type='hc'")
        self.model = model.eval()
        self.hop = model.kernel_size // 2
        self.chunk_samples = model.segment_size * self.hop
        self.reset()

    @property
    def device(self) -> torch.device:
        return self.model.decoder.weight.device

    def reset(self, batch: int = 1) -> None:
        m, dev = self.model, self.device
        self.batch = batch

        def zeros():
            z = torch.zeros(1, batch, m.unit, device=dev)
            return z, z.clone()

        # layer_in[i]: the state layer i starts the next segment from
        # (layer 0's stays zero); mem_state[i][tag]: Mem-LSTM i's own state.
        self.layer_in = [None] * m.layer
        self.mem_state = [{"h": zeros(), "c": zeros()} for _ in range(m.layer - 1)]
        self.raw_buf = torch.zeros(batch, 0, device=dev)
        self.frame_buf = torch.zeros(batch, 0, m.input_dim, device=dev)
        self.dec_tail = torch.zeros(batch * m.num_spk, m.kernel_size - self.hop, device=dev)

    def _mem_step(self, i: int, hc):
        """MemLSTM.forward_one_step: this segment's final (h, c) of layer i,
        each refined by one step of its Mem-LSTM (carrying that LSTM's own
        state), is layer i + 1's initial state for the next segment."""
        mem, state = self.model.separation.skim.mem_lstms[i], self.mem_state[i]
        refined = {}
        for tag, s in zip("hc", hc):
            net = getattr(mem, f"{tag}_net")
            vec = s[0]  # (B, H): one direction
            out, state[tag] = net.rnn.run(vec[:, None, :], state[tag])
            refined[tag] = vec + getattr(mem, f"{tag}_norm")(net.proj(out[:, 0]))
        return refined["h"][None], refined["c"][None]

    @torch.inference_mode()
    def _segment(self, enc: torch.Tensor) -> torch.Tensor:
        m = self.model
        sk = m.separation.skim
        out, next_in = enc, [None] * m.layer
        for i, seg in enumerate(sk.seg_lstms):
            out, hc = seg(out, self.layer_in[i])
            if i < m.layer - 1:
                next_in[i + 1] = self._mem_step(i, hc)
        self.layer_in = next_in
        dec = m.decode(enc, m.masks(out))  # (B·spks, fr·hop + k − hop)
        n_out = enc.shape[1] * self.hop
        head = dec[:, :self.dec_tail.shape[1]] + self.dec_tail
        dec = torch.cat([head, dec[:, self.dec_tail.shape[1]:]], dim=1)
        self.dec_tail = dec[:, n_out:]
        return dec[:, :n_out].reshape(-1, m.num_spk, n_out)

    @torch.inference_mode()
    def step(self, wav_chunk: torch.Tensor) -> torch.Tensor:
        """Feed (B, n) raw samples (on the model's device); returns
        (B, spks, m) for the samples that became ready (m grows in whole
        segments)."""
        m = self.model
        k, hop, seg = m.kernel_size, self.hop, m.segment_size
        x = wav_chunk[None] if wav_chunk.dim() == 1 else wav_chunk
        self.raw_buf = torch.cat([self.raw_buf, x.to(self.raw_buf.dtype)], dim=1)
        n_avail = self.raw_buf.shape[1]
        n_fr = (n_avail - k) // hop + 1 if n_avail >= k else 0
        if n_fr > 0:
            enc = m.encoder(self.raw_buf[:, :(n_fr - 1) * hop + k])
            self.frame_buf = torch.cat([self.frame_buf, enc], dim=1)
            self.raw_buf = self.raw_buf[:, n_fr * hop:]
        outs = []
        while self.frame_buf.shape[1] >= seg:
            outs.append(self._segment(self.frame_buf[:, :seg]))
            self.frame_buf = self.frame_buf[:, seg:]
        if not outs:
            return torch.zeros(x.shape[0], m.num_spk, 0, device=self.device)
        return torch.cat(outs, dim=-1)

    def stream(self, chunks, depth: int = 2):
        """Yield one numpy array per input chunk, exactly what :meth:`step`
        returns for it, keeping up to ``depth`` chunks in flight.

        On the card each output starts its copy to a pinned host buffer as
        soon as its segment is queued (``non_blocking``), and a CUDA event
        recorded after the copy is waited on only when that output is
        yielded, so the copies overlap the next ``depth`` segments' work.
        ``depth=0`` reads each output before the next chunk is fed. Latency
        grows by ``depth`` chunks."""
        pending: deque = deque()

        def enqueue(chunk):
            out = self.step(chunk)
            if out.is_cuda:
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                pending.append((host, done))
            else:
                pending.append((out.clone(), None))

        def pop():
            host, done = pending.popleft()
            if done is not None:
                done.synchronize()
            return host.numpy()

        for chunk in chunks:
            enqueue(chunk)
            while len(pending) > depth:
                yield pop()
        while pending:
            yield pop()

