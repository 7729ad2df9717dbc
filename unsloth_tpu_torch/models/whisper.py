"""Whisper ASR, in PyTorch: the log-mel front end and the encoder-decoder
(functional, over a param tree).

Counterpart of unsloth_tpu/models/whisper.py, with its param tree and
layouts: linear weights as ``{"kernel": [in, out], "bias"}``, convolution
kernels [C_out, C_in, K] (HF's), layer norms ``{"w", "b"}``, LoRA trees
``{"encoder": {"layers": [{"self_attn": {"q": LoRAWeights, ...}}]},
"decoder": {"layers": [{"self_attn": ..., "cross_attn": ...}]}}``.
Whisper layers are pre-LN transformer blocks with learned positions,
exact-GELU MLPs and, in the decoder, cross-attention; the decoder's logits
are tied to its embedding. Every layer norm goes through
``ops.rms_norm.layer_norm`` (K5/K6 on the card). Attention stays the
plain dense form of the JAX ``_mha`` (scores in the input dtype, softmax
in fp32), which reaches no Pallas kernel there either. The front end's FFT
and mel product are ``torch.fft`` and a plain matmul, as JAX leaves them
to XLA.

Divergences by design: :func:`whisper_greedy_decode` is a host loop (JAX
runs a ``lax.while_loop``), one host sync a step for the stop test; and
:func:`whisper_encode` casts the features to the convolution's dtype,
where JAX's ``lax.conv`` raises on fp32 features with bf16 weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cross_entropy import fast_cross_entropy_loss
from ..ops.lora import LoRAWeights
from ..ops.rms_norm import layer_norm


# ---------------------------------------------------------------------------
# Audio front end (whisper log-mel, 16 kHz)
# ---------------------------------------------------------------------------

def hann_window(n: int, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window's default), fp32."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)


def mel_filterbank(n_mels: int = 80, n_fft: int = 400,
                   sample_rate: int = 16000) -> np.ndarray:
    """Slaney-style mel filterbank matching librosa/whisper (htk=False)."""
    fmax = sample_rate / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mel = f / (200.0 / 3)
        log_region = f >= 1000.0
        mel = np.where(log_region,
                       15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                       / np.log(6.4) * 27.0, mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = m * (200.0 / 3)
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp(np.log(6.4) / 27.0
                                                 * (m - 15.0)), f)
        return f

    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    fft_freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    weights = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lower = (fft_freqs - freqs[i]) / (freqs[i + 1] - freqs[i])
        upper = (freqs[i + 2] - fft_freqs) / (freqs[i + 2] - freqs[i + 1])
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (freqs[2:n_mels + 2] - freqs[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80,
                        n_fft: int = 400, hop: int = 160,
                        pad_to_frames: Optional[int] = 3000) -> torch.Tensor:
    """waveform [T] or [B, T] (16 kHz) -> log-mel [B, n_mels, frames], fp32,
    on the waveform's device. Matches openai/whisper and transformers'
    WhisperFeatureExtractor: reflect pad, frames of ``n_fft`` every
    ``hop`` samples, periodic Hann window, |rfft|^2 without the last frame,
    the mel projection, log10 clamped at 1e-10, a floor 8 below the max,
    then (x + 4) / 4."""
    audio = torch.as_tensor(audio).to(torch.float32)
    if audio.ndim == 1:
        audio = audio[None]
    if pad_to_frames is not None:
        target = pad_to_frames * hop
        audio = audio[:, :target]
        audio = F.pad(audio, (0, target - audio.shape[1]))
    pad = n_fft // 2
    audio = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = audio.unfold(-1, n_fft, hop)                  # [B, F, n_fft]
    frames = frames * hann_window(n_fft, audio.device)
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2      # [B, F, bins]
    power = power[:, :-1, :]  # whisper drops the last frame
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft)).to(audio.device)
    mel = torch.einsum("bfk,mk->bmf", power, fb)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(
        log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51866
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_heads: int = 20
    decoder_layers: int = 32
    decoder_heads: int = 20
    ffn_dim: int = 5120
    num_mel_bins: int = 80
    max_source_positions: int = 1500
    max_target_positions: int = 448
    eps: float = 1e-5
    decoder_start_token_id: int = 50258
    pad_token_id: int = 50257
    eos_token_id: int = 50257

    @classmethod
    def from_hf(cls, hf: Dict[str, Any]) -> "WhisperConfig":
        return cls(
            vocab_size=int(hf["vocab_size"]),
            d_model=int(hf["d_model"]),
            encoder_layers=int(hf["encoder_layers"]),
            encoder_heads=int(hf["encoder_attention_heads"]),
            decoder_layers=int(hf["decoder_layers"]),
            decoder_heads=int(hf["decoder_attention_heads"]),
            ffn_dim=int(hf.get("encoder_ffn_dim", 4 * hf["d_model"])),
            num_mel_bins=int(hf.get("num_mel_bins", 80)),
            max_source_positions=int(hf.get("max_source_positions", 1500)),
            max_target_positions=int(hf.get("max_target_positions", 448)),
            decoder_start_token_id=int(
                hf.get("decoder_start_token_id", 50258)),
            pad_token_id=int(hf.get("pad_token_id", 50257)),
            eos_token_id=int(hf.get("eos_token_id", 50257)),
        )


def _lin(p, x: torch.Tensor, lora: Optional[LoRAWeights] = None
         ) -> torch.Tensor:
    y = torch.matmul(x, p["kernel"])
    if p.get("bias") is not None:
        y = y + p["bias"]
    if lora is not None:
        y = y + torch.matmul(torch.matmul(x, lora.a.t().to(x.dtype)),
                             lora.b.t().to(x.dtype)) * lora.scale
    return y


def _mha(x: torch.Tensor, kv: torch.Tensor, layer, heads: int, causal: bool,
         lora=None) -> torch.Tensor:
    """Dense attention as JAX's ``_mha``: the scores in x.dtype, then fp32
    and scaled, the causal mask (decoder self-attention), softmax in fp32,
    the probabilities back in x.dtype before P @ V."""
    lora = lora or {}
    b, t, d = x.shape
    s = kv.shape[1]
    dh = d // heads
    q = _lin(layer["q"], x, lora.get("q")).reshape(b, t, heads, dh)
    k = _lin(layer["k"], kv, lora.get("k")).reshape(b, s, heads, dh)
    v = _lin(layer["v"], kv, lora.get("v")).reshape(b, s, heads, dh)
    scores = torch.einsum("bthd,bshd->bhts", q, k).to(torch.float32) \
        * (dh ** -0.5)
    if causal:
        mask = torch.ones((t, s), dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, d)
    return _lin(layer["out"], out, lora.get("out"))


def _conv1d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
            stride: int) -> torch.Tensor:
    """x [B, C_in, T]; kernel [C_out, C_in, K] (HF layout), pad 1."""
    return F.conv1d(x, kernel, bias, stride=stride, padding=1)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def whisper_encode(params, features: torch.Tensor, cfg: WhisperConfig,
                   lora=None) -> torch.Tensor:
    """log-mel features [B, n_mels, frames] -> [B, frames // 2, d]. The
    features are cast to the convolution weights' dtype first."""
    enc = params["encoder"]
    enc_lora = (lora or {}).get("encoder", {})
    features = features.to(enc["conv1"]["kernel"].dtype)
    x = _gelu(_conv1d(features, enc["conv1"]["kernel"],
                      enc["conv1"]["bias"], 1))
    x = _gelu(_conv1d(x, enc["conv2"]["kernel"], enc["conv2"]["bias"], 2))
    x = x.transpose(1, 2)                        # [B, T, d]
    x = x + enc["pos_embed"][None, :x.shape[1]]
    layer_loras = enc_lora.get("layers", [{}] * len(enc["layers"]))
    for layer, ll in zip(enc["layers"], layer_loras):
        h = layer_norm(x, layer["ln1"]["w"], layer["ln1"]["b"], cfg.eps)
        x = x + _mha(h, h, layer["self_attn"], cfg.encoder_heads, False,
                     lora=ll.get("self_attn"))
        h = layer_norm(x, layer["ln2"]["w"], layer["ln2"]["b"], cfg.eps)
        h = _gelu(_lin(layer["fc1"], h))
        x = x + _lin(layer["fc2"], h)
    return layer_norm(x, enc["ln_post"]["w"], enc["ln_post"]["b"], cfg.eps)


def whisper_decode(params, token_ids: torch.Tensor,
                   encoder_out: torch.Tensor, cfg: WhisperConfig,
                   lora=None) -> torch.Tensor:
    """token_ids [B, T] + encoder states -> logits [B, T, V], tied to the
    token embedding."""
    dec = params["decoder"]
    dec_lora = (lora or {}).get("decoder", {})
    t = token_ids.shape[1]
    x = dec["embed"][token_ids.long()]
    x = x + dec["pos_embed"][None, :t]
    layer_loras = dec_lora.get("layers", [{}] * len(dec["layers"]))
    for layer, ll in zip(dec["layers"], layer_loras):
        h = layer_norm(x, layer["ln1"]["w"], layer["ln1"]["b"], cfg.eps)
        x = x + _mha(h, h, layer["self_attn"], cfg.decoder_heads, True,
                     lora=ll.get("self_attn"))
        h = layer_norm(x, layer["ln_x"]["w"], layer["ln_x"]["b"], cfg.eps)
        x = x + _mha(h, encoder_out, layer["cross_attn"], cfg.decoder_heads,
                     False, lora=ll.get("cross_attn"))
        h = layer_norm(x, layer["ln2"]["w"], layer["ln2"]["b"], cfg.eps)
        h = _gelu(_lin(layer["fc1"], h))
        x = x + _lin(layer["fc2"], h)
    x = layer_norm(x, dec["ln_post"]["w"], dec["ln_post"]["b"], cfg.eps)
    return torch.matmul(x, dec["embed"].t())


def whisper_loss(params, features, token_ids, labels, cfg: WhisperConfig,
                 lora=None) -> torch.Tensor:
    """Seq2seq CE (labels -100 = ignore; the caller shifts, as HF does),
    through the full-logits CE (K7/K8 on the card)."""
    enc = whisper_encode(params, features, cfg, lora=lora)
    logits = whisper_decode(params, token_ids, enc, cfg, lora=lora)
    return fast_cross_entropy_loss(logits, labels)


def init_whisper_lora(cfg: WhisperConfig, generator: torch.Generator,
                      r: int = 32, alpha: int = 64,
                      targets: Sequence[str] = ("q", "v"),
                      dtype: torch.dtype = torch.float32):
    """LoRA adapter tree mirroring the whisper param tree (peft
    convention: A ~ N(0, 1/r), as JAX draws it, B = 0; scale = alpha / r)
    on the attention projections ``targets`` of the encoder's
    self-attention and the decoder's self- and cross-attention, the
    reference's Whisper notebook's q_proj/v_proj by default. The numbers
    come from ``generator``, on its device."""
    device = generator.device
    d = cfg.d_model
    scale = alpha / r

    def adapter():
        a = torch.randn((r, d), generator=generator, device=device,
                        dtype=torch.float32) * (1.0 / r)
        return LoRAWeights(a=a.to(dtype),
                           b=torch.zeros((d, r), dtype=dtype, device=device),
                           scale=scale)

    def attn_block():
        return {t: adapter() for t in targets}

    enc_layers = [{"self_attn": attn_block()}
                  for _ in range(cfg.encoder_layers)]
    dec_layers = [{"self_attn": attn_block(), "cross_attn": attn_block()}
                  for _ in range(cfg.decoder_layers)]
    return {"encoder": {"layers": enc_layers},
            "decoder": {"layers": dec_layers}}


def whisper_lora_leaves(lora) -> list:
    """The trainable tensors of a Whisper LoRA tree (each adapter's a and
    b), in tree order: encoder layers, then decoder layers, attention
    blocks and targets sorted by name."""
    out = []
    for side in ("encoder", "decoder"):
        for layer in lora.get(side, {}).get("layers", []):
            for block in sorted(layer):
                for name in sorted(layer[block]):
                    w = layer[block][name]
                    out += [w.a, w.b]
    return out


@torch.no_grad()
def whisper_greedy_decode(params, features: torch.Tensor, cfg: WhisperConfig,
                          *, max_tokens: Optional[int] = None,
                          prompt_ids: Optional[Sequence[int]] = None,
                          lora=None) -> torch.Tensor:
    """Greedy transcription ids [B, max_tokens] (int32) from log-mel
    features, with JAX's semantics: a fixed id buffer of the prompt then
    ``pad_token_id``, the whole decoder recomputed over it at every step
    (no KV cache; position pos - 1's logits attend causally to written
    slots only, so the pad tail is inert), until every row has written
    eos or the buffer is full; finished rows are padded after their first
    eos. A host loop, where JAX runs a ``lax.while_loop``."""
    if prompt_ids is None or len(prompt_ids) == 0:
        prompt_ids = [cfg.decoder_start_token_id]
    max_tokens = int(max_tokens or cfg.max_target_positions)
    max_tokens = max(max_tokens, len(prompt_ids) + 1)
    enc = whisper_encode(params, features, cfg, lora=lora)
    b = features.shape[0]
    dev = enc.device
    ids = torch.full((b, max_tokens), cfg.pad_token_id, dtype=torch.int32,
                     device=dev)
    ids[:, :len(prompt_ids)] = torch.tensor(list(prompt_ids),
                                            dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    pos = len(prompt_ids)
    while pos < max_tokens and not bool(done.all()):
        logits = whisper_decode(params, ids, enc, cfg, lora=lora)
        nxt = torch.argmax(logits[:, pos - 1], dim=-1).to(torch.int32)
        nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id), nxt)
        ids[:, pos] = nxt
        done = done | (nxt == cfg.eos_token_id)
        pos += 1
    return ids


def whisper_transcribe(params, cfg: WhisperConfig, audio, *,
                       tokenizer=None, max_tokens: Optional[int] = None,
                       prompt_ids: Optional[Sequence[int]] = None,
                       lora=None):
    """Waveform (16 kHz float [T] or [B, T]) -> transcript text (with a
    tokenizer) or token-id lists (without), computed on the params'
    device. The prompt, everything from the first eos on and pad tokens
    are stripped from the returned ids."""
    dev = params["decoder"]["embed"].device
    audio = torch.as_tensor(np.asarray(audio, np.float32)).to(dev)
    if audio.ndim == 1:
        audio = audio[None]
    feats = log_mel_spectrogram(audio, n_mels=cfg.num_mel_bins)
    ids = whisper_greedy_decode(params, feats, cfg, max_tokens=max_tokens,
                                prompt_ids=prompt_ids, lora=lora)
    n_prompt = len(prompt_ids) if prompt_ids else 1
    out = []
    for row in ids.cpu().tolist():
        toks = [int(t) for t in row[n_prompt:]]
        if cfg.eos_token_id in toks:
            toks = toks[: toks.index(cfg.eos_token_id)]
        toks = [t for t in toks if t != cfg.pad_token_id]
        out.append(toks)
    if tokenizer is None:
        return out
    return [tokenizer.decode(t, skip_special_tokens=True) for t in out]


# ---------------------------------------------------------------------------
# HF checkpoint loading
# ---------------------------------------------------------------------------

def load_whisper(path: str, dtype: torch.dtype = torch.float32,
                 device="cuda"):
    """(param tree, WhisperConfig) from an HF Whisper checkpoint directory
    (``model.``-prefixed names or bare ones), every tensor in ``dtype`` on
    ``device``; linear weights transposed to ``kernel`` layout; k_proj has
    no bias unless the checkpoint holds one."""
    from .config import load_hf_config
    from .hf_loader import CheckpointReader

    hf = load_hf_config(path)
    cfg = WhisperConfig.from_hf(hf)
    reader = CheckpointReader(path)
    names = set(reader.names())
    prefix = "model." if "model.encoder.conv1.weight" in names else ""

    def get(name):
        return reader.get(prefix + name).to(device=device, dtype=dtype)

    def lin(stem, bias=True):
        return {"kernel": get(stem + ".weight").t().contiguous(),
                "bias": get(stem + ".bias") if bias else None}

    def attn(stem):
        return {
            "q": lin(stem + ".q_proj"),
            "k": lin(stem + ".k_proj",
                     bias=(prefix + stem + ".k_proj.bias") in names),
            "v": lin(stem + ".v_proj"),
            "out": lin(stem + ".out_proj"),
        }

    def ln(stem):
        return {"w": get(stem + ".weight"), "b": get(stem + ".bias")}

    encoder = {
        "conv1": {"kernel": get("encoder.conv1.weight"),
                  "bias": get("encoder.conv1.bias")},
        "conv2": {"kernel": get("encoder.conv2.weight"),
                  "bias": get("encoder.conv2.bias")},
        "pos_embed": get("encoder.embed_positions.weight"),
        "ln_post": ln("encoder.layer_norm"),
        "layers": [],
    }
    for i in range(cfg.encoder_layers):
        p = f"encoder.layers.{i}"
        encoder["layers"].append({
            "ln1": ln(p + ".self_attn_layer_norm"),
            "ln2": ln(p + ".final_layer_norm"),
            "self_attn": attn(p + ".self_attn"),
            "fc1": lin(p + ".fc1"),
            "fc2": lin(p + ".fc2"),
        })

    decoder = {
        "embed": get("decoder.embed_tokens.weight"),
        "pos_embed": get("decoder.embed_positions.weight"),
        "ln_post": ln("decoder.layer_norm"),
        "layers": [],
    }
    for i in range(cfg.decoder_layers):
        p = f"decoder.layers.{i}"
        decoder["layers"].append({
            "ln1": ln(p + ".self_attn_layer_norm"),
            "ln_x": ln(p + ".encoder_attn_layer_norm"),
            "ln2": ln(p + ".final_layer_norm"),
            "self_attn": attn(p + ".self_attn"),
            "cross_attn": attn(p + ".encoder_attn"),
            "fc1": lin(p + ".fc1"),
            "fc2": lin(p + ".fc2"),
        })
    return {"encoder": encoder, "decoder": decoder}, cfg
