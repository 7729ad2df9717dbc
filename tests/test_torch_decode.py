"""KV-cache decoding of the PyTorch port against the JAX package: a prefill
of left-padded rows plus 8 single-token steps through forward_with_cache,
dense and NF4 weights (carried across with interop), with and without
LoRA, and two more llama-family variants; logits compared in f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsloth_tpu.inference import decode as jdec
from unsloth_tpu.models.config import ModelConfig as JConfig
from unsloth_tpu.models.config import RopeScaling as JRope
from unsloth_tpu.models.params import init_lora_tree, init_params, quantize_params
from unsloth_tpu.ops.lora import LoRAWeights
from unsloth_tpu_torch.inference import decode as tdec
from unsloth_tpu_torch.interop import lora_from_numpy, params_from_numpy
from unsloth_tpu_torch.models.config import ModelConfig as TConfig
from unsloth_tpu_torch.models.config import RopeScaling as TRope

BASE = dict(model_type="llama", vocab_size=256, hidden_size=128,
            intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
            max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0)
LLAMA3 = dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
              high_freq_factor=4.0, original_max_position_embeddings=32)
VARIANTS = {
    "llama": {},
    "qwen3": dict(model_type="qwen3", qk_norm=True, attention_bias=True),
    "gemma2": dict(model_type="gemma2", hidden_act="gelu_tanh",
                   gemma_norm=True, use_post_norms=True,
                   embed_scale=128 ** 0.5, attn_softcap=50.0,
                   final_softcap=30.0, sliding_window=8,
                   layer_pattern=("sliding", "global"),
                   tie_word_embeddings=True),
}
STEPS = 8


def configs(variant):
    kw = dict(BASE, **VARIANTS[variant])
    rope = {} if variant != "llama" else LLAMA3
    return (JConfig(**kw, rope_scaling=JRope(**rope)),
            TConfig(**kw, rope_scaling=TRope(**rope)))


def _nonzero_lora(cfg, key):
    """init_lora_tree zeroes B; give it values so LoRA changes the output."""
    tree = init_lora_tree(cfg, key, r=4, alpha=8.0)
    rng = np.random.default_rng(7)
    for layer in tree["layers"]:
        for name, lw in list(layer.items()):
            b = rng.standard_normal(lw.b.shape).astype(np.float32) * 0.05
            layer[name] = LoRAWeights(lw.a, jnp.asarray(b), lw.scale)
    return tree


def run_jax(cfg, params, lora, ids, mask, steps):
    b, t = ids.shape
    cache = jdec.init_cache(cfg, b, t + steps, dtype=jnp.float32)
    first = np.argmax(mask, axis=1)
    pos = np.maximum(np.arange(t)[None] - first[:, None], 0)
    valid = np.ones((b, t + steps), bool)
    valid[:, :t] = mask.astype(bool)
    h, cache = jdec.forward_with_cache(
        params, lora, jnp.asarray(ids), cfg, cache, positions=jnp.asarray(pos),
        kv_valid_extra=jnp.asarray(valid))
    out = [np.asarray(jdec.logits_from_hidden(params, h[:, -1], cfg, lora))]
    nxt = pos[:, -1] + 1
    fed = []
    for _ in range(steps):
        tok = out[-1].argmax(-1)
        fed.append(tok)
        h, cache = jdec.forward_with_cache(
            params, lora, jnp.asarray(tok[:, None]), cfg, cache,
            positions=jnp.asarray(nxt[:, None]),
            kv_valid_extra=jnp.asarray(valid))
        out.append(np.asarray(jdec.logits_from_hidden(params, h, cfg,
                                                      lora))[:, 0])
        nxt = nxt + 1
    return np.stack(out), fed


def run_torch(cfg, params, lora, ids, mask, fed):
    b, t = ids.shape
    steps = len(fed)
    cache = tdec.init_cache(cfg, b, t + steps, dtype=torch.float32)
    first = np.argmax(mask, axis=1)
    pos = torch.from_numpy(np.maximum(np.arange(t)[None] - first[:, None], 0))
    valid = torch.ones((b, t + steps), dtype=torch.bool)
    valid[:, :t] = torch.from_numpy(mask.astype(bool))
    h, cache = tdec.forward_with_cache(
        params, lora, torch.from_numpy(ids), cfg, cache, positions=pos,
        kv_valid_extra=valid)
    assert cache.length == t
    out = [tdec.logits_from_hidden(params, h[:, -1], cfg, lora)]
    nxt = pos[:, -1] + 1
    for tok in fed:
        h, cache = tdec.forward_with_cache(
            params, lora, torch.from_numpy(tok[:, None]), cfg, cache,
            positions=nxt[:, None], kv_valid_extra=valid)
        out.append(tdec.logits_from_hidden(params, h, cfg, lora)[:, 0])
        nxt = nxt + 1
    assert cache.length == t + steps
    return torch.stack(out).numpy()


def _prompts(vocab):
    rng = np.random.default_rng(3)
    ids = rng.integers(1, vocab, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    for row, n_pad in ((1, 5), (2, 9)):      # left padding
        ids[row, :n_pad] = 0
        mask[row, :n_pad] = 0
    return ids, mask


@pytest.mark.parametrize("variant,quant,with_lora", [
    ("llama", False, False), ("llama", False, True),
    ("llama", True, False), ("llama", True, True),
    ("qwen3", True, False), ("gemma2", False, True),
])
def test_forward_with_cache_matches_jax(variant, quant, with_lora):
    jcfg, tcfg = configs(variant)
    jp = init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32,
                     init_scale=0.1)
    if quant:
        jp = quantize_params(jp, jcfg, dtype=jnp.float32)
    jl = _nonzero_lora(jcfg, jax.random.PRNGKey(1)) if with_lora else None
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tl = lora_from_numpy(jax.tree_util.tree_map(np.asarray, jl), "cpu") \
        if with_lora else None

    ids, mask = _prompts(jcfg.vocab_size)
    want, fed = run_jax(jcfg, jp, jl, ids, mask, STEPS)
    got = run_torch(tcfg, tp, tl, ids, mask, fed)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_unported_knob_raises():
    _, tcfg = configs("llama")
    # MoE under softmax-top-k routing is ported; DeepSeek's routing is not
    moe = dataclasses.replace(tcfg, num_experts=4, num_experts_per_tok=2,
                              moe_routing="deepseek")
    with pytest.raises(NotImplementedError, match="moe_routing"):
        tdec.forward_with_cache({"layers": []}, None,
                                torch.zeros((1, 1), dtype=torch.int64), moe,
                                tdec.init_cache(moe, 1, 2),
                                positions=torch.zeros((1, 1)))
