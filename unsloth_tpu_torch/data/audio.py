"""Audio IO helpers for the STT/TTS paths: WAV encode/decode and
resampling, in numpy only.

A copy of unsloth_tpu/data/audio.py (the port imports nothing of the JAX
package): the reference shells out to ffmpeg via whisper.cpp sidecars;
offline WAV/PCM is accepted directly."""

from __future__ import annotations

import io
import wave

import numpy as np


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """WAV bytes -> (mono float32 waveform in [-1, 1], sample_rate).
    Handles PCM 8/16/32-bit; multi-channel is averaged to mono."""
    with wave.open(io.BytesIO(data), "rb") as w:
        n_ch, width, rate = w.getnchannels(), w.getsampwidth(), \
            w.getframerate()
        frames = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(frames, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(frames, "<i4").astype(np.float32) / 2147483648.0
    elif width == 1:  # unsigned 8-bit
        x = (np.frombuffer(frames, np.uint8).astype(np.float32)
             - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, rate


def encode_wav(audio: np.ndarray, sample_rate: int = 16000) -> bytes:
    """Mono float waveform in [-1, 1] -> 16-bit PCM WAV bytes."""
    pcm = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    # same 1/32768 scale the decoder uses, so round-trip error stays
    # within half an LSB (the +1.0 endpoint clips to 32767)
    pcm = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def resample(audio: np.ndarray, rate_in: int,
             rate_out: int = 16000) -> np.ndarray:
    """Linear-interpolation resample (adequate for 16 kHz speech
    frontends; whisper's mel filterbank low-passes above ~8 kHz)."""
    audio = np.asarray(audio, np.float32)
    if rate_in == rate_out:
        return audio
    n_out = int(round(len(audio) * rate_out / rate_in))
    t_out = np.arange(n_out, dtype=np.float64) * (rate_in / rate_out)
    return np.interp(t_out, np.arange(len(audio)), audio) \
        .astype(np.float32)
