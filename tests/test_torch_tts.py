"""The port's speech data helpers against the JAX package's: every function
of data/tts.py (the Orpheus SNAC-token pipeline and OrpheusSpeaker, with a
synthetic codec) and of data/audio.py, on the same seeded inputs, with
equal outputs; then OrpheusSpeaker and a short Orpheus-format SFT run on a
tiny model of the port itself."""

import numpy as np
import pytest
import torch

from unsloth_tpu.data import audio as jaudio
from unsloth_tpu.data import tts as jtts
from unsloth_tpu_torch.data import audio as taudio
from unsloth_tpu_torch.data import tts as ttts


class ToyTok:
    def encode(self, text, add_special_tokens=True):
        return [1] + [ord(c) % 100 + 2 for c in text]


def _layers(n_frames, seed=0, cb=4096):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cb, n_frames).tolist(),
            rng.randint(0, cb, 2 * n_frames).tolist(),
            rng.randint(0, cb, 4 * n_frames).tolist()]


#: a token map rebased below 256, for the tiny models
SMALL = dict(start_of_human=200, end_of_human=201, start_of_ai=202,
             end_of_ai=203, start_of_speech=204, end_of_speech=205,
             end_of_text=206, audio_offset=210, codebook_size=4)


def test_tokens_match_jax():
    assert ttts.ORPHEUS_TOKENS.__dict__ == jtts.ORPHEUS_TOKENS.__dict__
    assert ttts.OrpheusTokens(**SMALL).__dict__ == \
        jtts.OrpheusTokens(**SMALL).__dict__


@pytest.mark.parametrize("n_frames", [0, 1, 5])
def test_interleave_split_and_dedup_match_jax(n_frames):
    layers = _layers(n_frames, seed=n_frames)
    codes = ttts.interleave_snac_codes(layers)
    assert codes == jtts.interleave_snac_codes(layers)
    t = ttts.ORPHEUS_TOKENS
    ids = [t.start_of_speech] + codes + [t.end_of_speech, 7]
    assert ttts.split_orpheus_output(ids) == jtts.split_orpheus_output(ids)
    assert [list(x) for x in ttts.split_orpheus_output(ids)] == layers
    # no start marker, a ragged tail: both cut to whole frames alike
    assert ttts.split_orpheus_output(codes[:-3]) == \
        jtts.split_orpheus_output(codes[:-3])
    frame_a, frame_b = list(range(7)), list(range(100, 107))
    rep = frame_a + frame_a + frame_b + frame_b + frame_a + codes
    assert ttts.dedup_frames(rep) == jtts.dedup_frames(rep)
    assert ttts.dedup_frames(rep[:5]) == rep[:5]


@pytest.mark.parametrize("speaker", [None, "zoe"])
def test_format_orpheus_example_matches_jax(speaker):
    codes = ttts.interleave_snac_codes(_layers(3))
    for max_length in (2048, 12):
        got = ttts.format_orpheus_example("hello", codes, ToyTok(),
                                          speaker=speaker,
                                          max_length=max_length)
        want = jtts.format_orpheus_example("hello", codes, ToyTok(),
                                           speaker=speaker,
                                           max_length=max_length)
        assert got == want and got["labels"] == got["input_ids"]


def test_prepare_tts_dataset_matches_jax():
    ds = [
        {"text": "a", "snac_codes": _layers(2), "source": "tara"},
        {"text": "b", "audio_codes": ttts.interleave_snac_codes(_layers(1))},
        {"text": "", "snac_codes": _layers(2)},     # skipped: no text
        {"text": "c"},                               # skipped: no audio
        {"text": "d", "audio": {"array": np.zeros(10),
                                "sampling_rate": 24000}},
        {"text": "e", "audio": np.zeros(4)},
        {"text": "f", "snac_codes": [[1, 1], [2, 3, 2, 3],
                                     [4, 5, 6, 7, 4, 5, 6, 7]]},
    ]
    seen = []

    def encode(arr, sr):
        seen.append(sr)
        return _layers(2, seed=7)

    for kw in ({}, {"dedup": False, "max_length": 20},
               {"speaker_field": None,
                "tokens": ttts.OrpheusTokens(**SMALL)}):
        jkw = dict(kw)
        if "tokens" in kw:
            jkw["tokens"] = jtts.OrpheusTokens(**SMALL)
        got = ttts.prepare_tts_dataset(ds, ToyTok(), encode_fn=encode, **kw)
        want = jtts.prepare_tts_dataset(ds, ToyTok(), encode_fn=encode,
                                        **jkw)
        assert got == want and len(got) == 5
    assert seen[:2] == [24000, 24000]
    assert len(ttts.prepare_tts_dataset(ds, ToyTok())) == 3


class _Codec:
    """Synthetic vocoder: one 8-sample tone a frame, pitched by the frame's
    first-layer code, scaled by its mean second- and third-layer codes."""

    def __init__(self):
        self.layers = None

    def decode(self, layers):
        self.layers = [list(x) for x in layers]
        l0, l1, l2 = (np.asarray(x, np.float32) for x in layers)
        t = np.arange(8, dtype=np.float32)
        out = [np.sin(0.1 * (l0[f] + 1) * t)
               * (1 + l1[2 * f:2 * f + 2].mean() + l2[4 * f:4 * f + 4].mean())
               / 10000.0 for f in range(len(l0))]
        return np.concatenate(out) if out else np.zeros(0, np.float32)


def test_orpheus_speaker_matches_jax():
    """Both speakers frame the same prompt, split the same generated ids
    and hand the codec the same layers."""
    layers = _layers(4, seed=3)
    codes = ttts.interleave_snac_codes(layers)
    t = ttts.ORPHEUS_TOKENS
    prompts = []

    class Model:
        def generate(self, batch, params, **kw):
            prompts.append(list(batch[0]))
            assert kw.get("return_token_ids") and params.temperature == 0.0
            return [codes + [t.end_of_speech, 99]]

    out = []
    for mod in (ttts, jtts):
        codec = _Codec()
        audio, rate = mod.OrpheusSpeaker(Model(), ToyTok(), codec).speak(
            "hi", voice="tara")
        out.append((audio, rate, codec.layers))
    assert prompts[0] == prompts[1]
    assert prompts[0][0] == t.start_of_human
    assert prompts[0][-2:] == [t.start_of_ai, t.start_of_speech]
    (a1, r1, c1), (a2, r2, c2) = out
    assert r1 == r2 == 24000 and c1 == c2 == layers
    assert a1.dtype == np.float32 and a1.shape == (32,)
    np.testing.assert_array_equal(a1, a2)


def _tiny_model(seed=0):
    from unsloth_tpu_torch.models.config import ModelConfig
    from unsloth_tpu_torch.models.loader import LanguageModel
    from unsloth_tpu_torch.models.params import init_lora_tree, init_params

    cfg = ModelConfig(vocab_size=256, hidden_size=32, intermediate_size=64,
                      num_layers=2, num_heads=2, num_kv_heads=2,
                      max_position_embeddings=128)
    g = torch.Generator().manual_seed(seed)
    model = LanguageModel(cfg=cfg, params=init_params(cfg, g),
                          max_seq_length=64)
    model.lora = init_lora_tree(cfg, g, r=4, alpha=8)
    return model


def test_orpheus_speaker_on_a_port_model():
    """Text -> the port's greedy generate -> split -> codec, end to end on
    a tiny model with the rebased token map."""
    toks = ttts.OrpheusTokens(**SMALL)
    codec = _Codec()
    spk = ttts.OrpheusSpeaker(_tiny_model(), ToyTok(), codec, tokens=toks,
                              max_tokens=21)
    audio, rate = spk.speak("hi")
    assert rate == 24000 and audio.dtype == np.float32
    assert len(codec.layers[0]) * 8 == audio.shape[0]
    assert len(codec.layers[1]) == 2 * len(codec.layers[0])
    assert np.all(np.isfinite(audio))


def test_tts_sft_on_a_port_model():
    """A tiny model of the port overfits Orpheus-format rows (the Whisper +
    Orpheus config of BASELINE.md:35), as the JAX package's test does on
    its own model."""
    from unsloth_tpu_torch.trainer.sft import SFTConfig, SFTTrainer

    toks = ttts.OrpheusTokens(**SMALL)
    rng = np.random.RandomState(0)
    ds = [{"text": "hi",
           "snac_codes": [rng.randint(0, 4, 2).tolist(),
                          rng.randint(0, 4, 4).tolist(),
                          rng.randint(0, 4, 8).tolist()]}
          for _ in range(8)]
    examples = ttts.prepare_tts_dataset(ds, ToyTok(), tokens=toks,
                                        dedup=False)
    assert all(max(e["input_ids"]) < 256 for e in examples)
    model = _tiny_model(1)
    args = SFTConfig(per_device_train_batch_size=4, max_steps=10,
                     max_seq_length=64, packing=False, learning_rate=5e-3,
                     lr_scheduler_type="constant", warmup_steps=0)
    tr = SFTTrainer(model, train_dataset=examples, args=args)
    tr.train()
    losses = [e["loss"] for e in tr.state_log]
    assert len(losses) == 10 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("width,channels", [(2, 1), (1, 1), (4, 2)])
def test_wav_codec_matches_jax(width, channels):
    import io
    import wave

    rng = np.random.default_rng(width)
    x = np.clip(rng.standard_normal(300 * channels) * 0.3, -1, 1)
    if width == 2:
        pcm = (x * 32767).astype("<i2").tobytes()
    elif width == 4:
        pcm = (x * 2 ** 31 * 0.99).astype("<i4").tobytes()
    else:
        pcm = ((x + 1) * 127.5).astype(np.uint8).tobytes()
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(22050)
        w.writeframes(pcm)
    got, rate = taudio.decode_wav(buf.getvalue())
    want, jrate = jaudio.decode_wav(buf.getvalue())
    assert rate == jrate == 22050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    enc = taudio.encode_wav(got, 16000)
    assert enc == jaudio.encode_wav(got, 16000)
    back, _ = taudio.decode_wav(enc)
    assert np.max(np.abs(back - np.clip(got, -1, 1))) <= 0.5 / 32768 + 1e-7
    for rate_out in (16000, 22050, 24000):
        np.testing.assert_array_equal(taudio.resample(got, 22050, rate_out),
                                      jaudio.resample(got, 22050, rate_out))
