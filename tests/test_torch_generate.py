"""generate() of the PyTorch port: greedy ids equal to the JAX package's on
left-padded prompts (f32, dense and NF4), EOS stops a row, a seeded
temperature sample repeats itself, top_k=1 is greedy and a LoRA adapter
from get_peft_model is served."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unsloth_tpu.models.config import ModelConfig as JConfig
from unsloth_tpu.models.config import RopeScaling as JRope
from unsloth_tpu.models.loader import LanguageModel as JModel
from unsloth_tpu.models.params import init_params, quantize_params
from unsloth_tpu_torch.inference.generate import SamplingParams, generate
from unsloth_tpu_torch.interop import params_from_numpy
from unsloth_tpu_torch.models.config import ModelConfig as TConfig
from unsloth_tpu_torch.models.config import RopeScaling as TRope
from unsloth_tpu_torch.models.loader import LanguageModel as TModel

CFG = dict(model_type="llama", vocab_size=256, hidden_size=128,
           intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
           max_position_embeddings=256, rms_norm_eps=1e-5)
LLAMA3 = dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
              high_freq_factor=4.0, original_max_position_embeddings=32)
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [3] * 20 + [4, 5], [200, 17]]
NEW = 10


def _models(quant):
    jcfg = JConfig(**CFG, rope_scaling=JRope(**LLAMA3))
    tcfg = TConfig(**CFG, rope_scaling=TRope(**LLAMA3))
    jp = init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32,
                     init_scale=0.1)
    if quant:
        jp = quantize_params(jp, jcfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return JModel(cfg=jcfg, params=jp), TModel(cfg=tcfg, params=tp)


@pytest.fixture(scope="module")
def dense():
    return _models(False)


@pytest.mark.parametrize("quant", [False, True])
def test_greedy_ids_match_jax(quant, dense):
    jm, tm = dense if not quant else _models(True)
    want = jm.generate(PROMPTS, max_new_tokens=NEW, temperature=0.0,
                       return_token_ids=True)
    got = tm.generate(PROMPTS, max_new_tokens=NEW, temperature=0.0,
                      return_token_ids=True)
    assert got == want
    assert all(len(r) == NEW for r in got)


def test_eos_stops_generation(dense):
    _, tm = dense
    full = tm.generate(PROMPTS, max_new_tokens=NEW, temperature=0.0,
                       return_token_ids=True)
    eos = full[0][3]
    got = generate(tm, PROMPTS, SamplingParams(max_tokens=NEW,
                                               stop_token_ids=(eos,)),
                   return_token_ids=True)
    for want, row in zip(full, got):
        cut = want.index(eos) if eos in want else len(want)
        assert row == want[:cut]
    assert len(got[0]) == full[0].index(eos) <= 3


def test_seeded_temperature_sampling_repeats(dense):
    _, tm = dense
    p = SamplingParams(max_tokens=NEW, temperature=1.0, top_p=0.9, seed=11)
    a = generate(tm, PROMPTS, p, return_token_ids=True)
    b = generate(tm, PROMPTS, p, return_token_ids=True)
    assert a == b
    other = generate(tm, PROMPTS, SamplingParams(max_tokens=NEW,
                                                 temperature=1.0, seed=12),
                     return_token_ids=True)
    assert other != a


def test_top_k_one_is_greedy(dense):
    _, tm = dense
    greedy = tm.generate(PROMPTS, max_new_tokens=NEW, temperature=0.0,
                         return_token_ids=True)
    top1 = generate(tm, PROMPTS, SamplingParams(max_tokens=NEW,
                                                temperature=0.7, top_k=1,
                                                seed=5),
                    return_token_ids=True)
    assert top1 == greedy


@pytest.mark.parametrize("kw", [dict(speculative=True),
                                dict(kv_cache_dtype="fp8_e5m2"),
                                dict(kv_cache_dtype="fp8_e4m3")])
def test_unported_options_raise(dense, kw):
    _, tm = dense
    with pytest.raises(NotImplementedError):
        tm.generate(PROMPTS, max_new_tokens=2, **kw)


def test_peft_adapter_serves():
    """get_peft_model attaches a zero-B adapter (same greedy ids); a nonzero
    B changes them, and lora=None serves the bare base again."""
    _, tm = _models(False)
    base = tm.generate(PROMPTS, max_new_tokens=NEW, return_token_ids=True)
    tm = tm.get_peft_model(r=4, lora_alpha=8.0)
    assert set(tm.lora["layers"][0]) == {"q", "k", "v", "o", "gate", "up",
                                         "down"}
    assert tm.generate(PROMPTS, max_new_tokens=NEW,
                       return_token_ids=True) == base
    for layer in tm.lora["layers"]:
        for lw in layer.values():
            lw.b.fill_(0.5)
    assert tm.generate(PROMPTS, max_new_tokens=NEW,
                       return_token_ids=True) != base
    assert tm.generate(PROMPTS, max_new_tokens=NEW, return_token_ids=True,
                       lora=None) == base
