"""TTS (Orpheus-style) audio-token SFT pipeline.

A copy of unsloth_tpu/data/tts.py (the port imports nothing of the JAX
package), with the same semantics: SNAC codec codes (24 kHz, 3
hierarchical layers) interleaved 7 codes a frame with per-slot vocabulary
offsets, wrapped in the Orpheus special tokens, and trained on the full
sequence (no label masking), as the reference's SNAC preprocessing for
Orpheus-TTS training does (studio/backend/core/training/trainer.py:
1537-1726 ``_preprocess_snac_dataset``, the Orpheus_(3B)-TTS notebook).

No SNAC checkpoint is at hand offline, so the codec step is pluggable:
examples may carry pre-computed ``snac_codes`` (the three layers) or
already-interleaved ``audio_codes``; an ``encode_fn(audio_array,
sampling_rate) -> [l0, l1, l2]`` hook plugs a real codec in. Everything
after the codec is exact. :class:`OrpheusSpeaker` generates through the
port's ``LanguageModel.generate``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class OrpheusTokens:
    """Special token ids hardcoded in the Orpheus-3B (llama-3) vocab."""

    start_of_human: int = 128259
    end_of_human: int = 128260
    start_of_ai: int = 128261
    end_of_ai: int = 128262
    start_of_speech: int = 128257
    end_of_speech: int = 128258
    end_of_text: int = 128009
    audio_offset: int = 128266
    codebook_size: int = 4096


ORPHEUS_TOKENS = OrpheusTokens()


def interleave_snac_codes(layers: Sequence[Sequence[int]],
                          tokens: OrpheusTokens = ORPHEUS_TOKENS
                          ) -> List[int]:
    """SNAC's 3 hierarchical layers -> flat 7-codes-per-frame stream.

    Layer shapes per frame: l0 has 1 code, l1 has 2, l2 has 4; slot k of a
    frame gets vocabulary offset audio_offset + k * 4096 (notebook cells
    134-142)."""
    l0, l1, l2 = layers
    out: List[int] = []
    off = tokens.audio_offset
    cb = tokens.codebook_size
    for i in range(len(l0)):
        out.append(int(l0[i]) + off)
        out.append(int(l1[2 * i]) + off + cb)
        out.append(int(l2[4 * i]) + off + 2 * cb)
        out.append(int(l2[4 * i + 1]) + off + 3 * cb)
        out.append(int(l1[2 * i + 1]) + off + 4 * cb)
        out.append(int(l2[4 * i + 2]) + off + 5 * cb)
        out.append(int(l2[4 * i + 3]) + off + 6 * cb)
    return out


def dedup_frames(codes: List[int]) -> List[int]:
    """Drop consecutive frames whose FIRST code repeats (notebook
    185-207 — removes silence/held frames)."""
    if len(codes) < 7:
        return list(codes)
    out = list(codes[:7])
    for i in range(7, len(codes), 7):
        if codes[i] != out[-7]:
            out.extend(codes[i:i + 7])
    return out


def format_orpheus_example(
    text: str,
    audio_codes: List[int],
    tokenizer,
    speaker: Optional[str] = None,
    max_length: int = 2048,
    tokens: OrpheusTokens = ORPHEUS_TOKENS,
) -> Dict[str, List[int]]:
    """One TTS training example: [SOH] text [EOT] [EOH][SOA][SOS] codes
    [EOS'][EOA]; labels = input_ids (Orpheus trains the full sequence)."""
    prompt = f"{speaker}: {text}" if speaker else text
    text_ids = tokenizer.encode(prompt, add_special_tokens=True)
    text_ids = list(text_ids) + [tokens.end_of_text]
    input_ids = (
        [tokens.start_of_human] + text_ids + [tokens.end_of_human]
        + [tokens.start_of_ai, tokens.start_of_speech]
        + list(audio_codes)
        + [tokens.end_of_speech, tokens.end_of_ai]
    )[:max_length]
    return {"input_ids": input_ids, "labels": list(input_ids)}


def prepare_tts_dataset(
    dataset,
    tokenizer,
    *,
    text_field: str = "text",
    speaker_field: Optional[str] = "source",
    max_length: int = 2048,
    encode_fn: Optional[Callable] = None,
    dedup: bool = True,
    tokens: OrpheusTokens = ORPHEUS_TOKENS,
) -> List[Dict[str, List[int]]]:
    """Dataset of {text, snac_codes|audio_codes|audio} -> SFT examples.

    Priority per example: ``audio_codes`` (already interleaved) >
    ``snac_codes`` (3 layers) > ``audio`` + encode_fn. Examples without
    usable audio or text are skipped, like the reference."""
    out = []
    for ex in dataset:
        text = ex.get(text_field)
        if not text:
            continue
        codes = ex.get("audio_codes")
        if codes is None:
            layers = ex.get("snac_codes")
            if layers is None and encode_fn is not None \
                    and ex.get("audio") is not None:
                audio = ex["audio"]
                layers = encode_fn(
                    audio.get("array") if isinstance(audio, dict)
                    else audio,
                    audio.get("sampling_rate", 24000)
                    if isinstance(audio, dict) else 24000)
            if layers is None:
                continue
            codes = interleave_snac_codes(layers, tokens)
        if not codes:
            continue
        if dedup:
            codes = dedup_frames(list(codes))
        speaker = ex.get(speaker_field) if speaker_field else None
        out.append(format_orpheus_example(
            str(text), codes, tokenizer, speaker=speaker,
            max_length=max_length, tokens=tokens))
    return out


def split_orpheus_output(ids: Sequence[int],
                         tokens: OrpheusTokens = ORPHEUS_TOKENS):
    """Generated ids -> per-layer SNAC codes (the inverse of
    interleave_snac_codes), for decoding with a SNAC vocoder."""
    ids = list(ids)
    try:
        lo = ids.index(tokens.start_of_speech) + 1
    except ValueError:
        lo = 0
    hi = ids.index(tokens.end_of_speech) if tokens.end_of_speech in ids \
        else len(ids)
    codes = [i - tokens.audio_offset for i in ids[lo:hi]]
    codes = codes[:len(codes) // 7 * 7]
    cb = tokens.codebook_size
    l0, l1, l2 = [], [], []
    for f in range(0, len(codes), 7):
        l0.append(codes[f] % cb)
        l1.extend([codes[f + 1] % cb, codes[f + 4] % cb])
        l2.extend([codes[f + 2] % cb, codes[f + 3] % cb,
                   codes[f + 5] % cb, codes[f + 6] % cb])
    return l0, l1, l2


class OrpheusSpeaker:
    """Text -> waveform through an Orpheus-style TTS LM + a SNAC-class
    codec (reference: the Orpheus notebook flow — generate audio tokens,
    split into SNAC layers, vocode). The codec is pluggable: any object
    with `decode(layers) -> float waveform` (a SNAC vocoder in the
    reference; tests use a synthetic codec).

    The JAX package's studio server serves `/v1/audio/speech` through
    it; the port has no studio yet.
    """

    def __init__(self, model, tokenizer, codec, *,
                 sample_rate: int = 24000,
                 tokens: OrpheusTokens = ORPHEUS_TOKENS,
                 max_tokens: int = 1792):
        self.model = model
        self.tokenizer = tokenizer
        self.codec = codec
        self.sample_rate = sample_rate
        self.tokens = tokens
        self.max_tokens = max_tokens

    def speak(self, text: str, voice: Optional[str] = None):
        """Returns (waveform float32 ndarray, sample_rate)."""
        import numpy as np

        t = self.tokens
        prompt = f"{voice}: {text}" if voice else text
        text_ids = list(self.tokenizer.encode(
            prompt, add_special_tokens=True)) + [t.end_of_text]
        input_ids = ([t.start_of_human] + text_ids + [t.end_of_human]
                     + [t.start_of_ai, t.start_of_speech])
        from ..inference.generate import SamplingParams

        out = self.model.generate(
            [input_ids],
            SamplingParams(max_tokens=self.max_tokens, temperature=0.0),
            return_token_ids=True)
        ids = input_ids + [int(x) for x in out[0]]
        layers = split_orpheus_output(ids, self.tokens)
        audio = np.asarray(self.codec.decode(layers), np.float32).ravel()
        return audio, self.sample_rate
