"""Gemma-2 training in the PyTorch port against the JAX package, on the CPU:
the plain versions of the splash-attention kernels (K18) against the JAX
Pallas splash kernels in interpret mode, the dispatcher's CPU route against
them, the check that holds K18 on the card against injected faults, a
Gemma-2 checkpoint loaded as the JAX package loads it, and padded-row
SFTTrainer on a tiny Gemma-2 (sliding and global layers, both softcaps,
sandwich norms, tied embedding, NF4 carried byte for byte) with
response-only labels (batches, losses, adapters, evaluate)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from unsloth_tpu.models import decoder as jdec
from unsloth_tpu.models import hf_loader as jloader
from unsloth_tpu.models.config import ModelConfig as JConfig
from unsloth_tpu.models.loader import LanguageModel as JModel
from unsloth_tpu.models.params import (init_lora_tree, init_params,
                                       quantize_params)
from unsloth_tpu.ops.attention import _tpu_splash
from unsloth_tpu.ops.lora import LoRAWeights
from unsloth_tpu.trainer import sft as jsft
from unsloth_tpu_torch import FastLanguageModel
from unsloth_tpu_torch.interop import (lora_from_numpy, lora_to_numpy,
                                       params_from_numpy)
from unsloth_tpu_torch.models import decoder as tdec
from unsloth_tpu_torch.models.config import ModelConfig as TConfig
from unsloth_tpu_torch.models.loader import LanguageModel as TModel
from unsloth_tpu_torch.ops import attention as tatt
from unsloth_tpu_torch.ops import splash_attention as tsa
from unsloth_tpu_torch.trainer import sft as tsft
from tests.test_torch_unpacked import (INSTR, RESP, T, ByteTokenizer,
                                       _alpaca_texts)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# (a) K18: the plain versions against the bundled splash kernels (interpret)
# ---------------------------------------------------------------------------

#: id -> (head dim, window, softcap, scale): Gemma-2-9B's head dim and scale
#: (query_pre_attn_scalar 256), Gemma-2-27B's (head dim 128, scalar 144),
#: a window of 64 tokens (it bites at T = 256), the attention softcap of 50
SPLASH_CASES = {
    "d256-window-softcap": (256, 64, 50.0, 256 ** -0.5),
    "d128-window-softcap": (128, 64, 50.0, 144 ** -0.5),
    "d256-softcap": (256, None, 50.0, 256 ** -0.5),
    "d128-window": (128, 64, None, 128 ** -0.5),
}


def _splash_inputs(d, seed=0, t=256, hq=4, hkv=2, qk_std=3.0):
    """q, k (std ``qk_std``: scores of the order of the softcap), v, dout,
    and segment ids of two rows: a padded one (180 real tokens, then pad
    id 0, as pad_batch writes it) and a packed one (segments of 70, 130 and
    56 tokens)."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((2, t, hq, d)) * qk_std).astype(np.float32)
    k = (rng.standard_normal((2, t, hkv, d)) * qk_std).astype(np.float32)
    v = rng.standard_normal((2, t, hkv, d)).astype(np.float32)
    dout = rng.standard_normal((2, t, hq, d)).astype(np.float32)
    seg = np.zeros((2, t), np.int32)
    seg[0, :180] = 1
    seg[1, :70], seg[1, 70:200], seg[1, 200:] = 1, 2, 3
    return q, k, v, dout, seg


@pytest.fixture(scope="module", params=list(SPLASH_CASES))
def jax_splash(request):
    """_tpu_splash (the bundled Pallas splash kernels, interpret mode):
    out and d(sum out * dout)/d(q, k, v) for one case."""
    d, window, softcap, scale = SPLASH_CASES[request.param]
    q, k, v, dout, seg = _splash_inputs(d)

    def f(q_, k_, v_):
        return _tpu_splash(q_, k_, v_, causal=True,
                           segment_ids=jnp.asarray(seg), window=window,
                           softcap=softcap, scale=scale, interpret=True)

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(dout)),
                     argnums=(0, 1, 2))(*args)
    opts = dict(window=window, softcap=softcap, scale=scale)
    return (q, k, v, dout, seg), opts, np.asarray(out), [np.asarray(x)
                                                         for x in grads]


def test_splash_plain_forward_matches_pallas(jax_splash):
    """Output at every position, pad included, f32: 1e-5."""
    (q, k, v, _, seg), opts, want, _ = jax_splash
    got = tsa.splash_attention(_t(q), _t(k), _t(v), _t(seg), **opts)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_splash_plain_grads_match_pallas(jax_splash):
    """dq, dk, dv (GQA summed over each kv head's query heads, the softcap's
    1 - tanh^2 in dS) at every position, f32: 1e-4 of the largest value
    (fp32 sums in other orders)."""
    (q, k, v, dout, seg), opts, _, want = jax_splash
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tsa.splash_attention(tq, tk, tv, _t(seg), **opts)
    torch.autograd.backward(out, _t(dout))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("window,softcap", [(64, None), (None, 50.0),
                                            (64, 50.0)])
def test_attention_cpu_route_matches_splash(window, softcap):
    """The dispatcher's CPU route (attention_ref) with a window or softcap
    against splash_attention's plain route at a ragged T (not a multiple of
    the 64-token tile): outputs and q/k/v gradients, f32, within 1e-5 of
    each tensor's largest value (the same formulas, fp32 sums in other
    orders)."""
    q, k, v, dout, seg = (_t(x) for x in _splash_inputs(128, seed=1, t=200))
    seg[1, 200 - 13:] = 0
    scale = 0.1
    grads = []
    for fn in (tatt.attention, tsa.splash_attention):
        tq, tk, tv = (x.clone().requires_grad_(True) for x in (q, k, v))
        if fn is tatt.attention:
            out = fn(tq, tk, tv, causal=True, segment_ids=seg, window=window,
                     softcap=softcap, scale=scale)
        else:
            out = fn(tq, tk, tv, seg, window=window, softcap=softcap,
                     scale=scale)
        torch.autograd.backward(out, dout)
        grads.append((out.detach(), tq.grad, tk.grad, tv.grad))
    for got, want in zip(*grads):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_splash_check_rejects_faults():
    """chip_smoke's row-wise check of K18, on the plain versions (f32, a
    padded and a packed row, window 64, softcap 50, scores of the order of
    the softcap): the reference rounded to bf16 passes it, and each fault
    fails it in every tensor it touches: a dropped kv tile, an ignored pad
    mask, a 10% error in the second half of a row, the window ignored, and
    the softcap's 1 - tanh^2 factor left out of the backward (dq, dk)."""
    d, window, softcap, scale = SPLASH_CASES["d256-window-softcap"]
    q, k, v, dout, seg = (_t(x) for x in _splash_inputs(d, seed=5))
    opts = dict(window=window, softcap=softcap, scale=scale)
    out, lse = tsa.splash_attention_fwd_ref(q, k, v, seg, **opts)
    want = (out,) + tsa.splash_attention_bwd_ref(q, k, v, seg, out, lse, dout,
                                                 **opts)
    for x in want:
        assert chip_smoke.attn_row_err(x.to(torch.bfloat16), x) <= \
            chip_smoke.ATTN_ROW_TOL
    res = chip_smoke.attn_fault_errs(q, k, v, seg, dout, scale, want,
                                     window=window, softcap=softcap)
    assert set(res) == {"kv tile dropped", "pad mask ignored",
                        "late half 10% off", "window ignored",
                        "softcap derivative dropped"}
    assert set(res["softcap derivative dropped"]) == {"dq", "dk"}
    for fault, errs in res.items():
        for name, (err, _) in errs.items():
            assert err > chip_smoke.ATTN_ROW_TOL, (fault, name, err)


# ---------------------------------------------------------------------------
# (b) a Gemma-2 checkpoint (chip_smoke's writer at a tiny size)
# ---------------------------------------------------------------------------

TINY_GEMMA2_HF = dict(
    chip_smoke.GEMMA2_9B_CONFIG, hidden_size=128, intermediate_size=256,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    head_dim=48, vocab_size=300, query_pre_attn_scalar=24, sliding_window=16,
    max_position_embeddings=256)


def test_gemma2_checkpoint_loads_as_in_jax(tmp_path, monkeypatch):
    """The Gemma-2 checkpoint chip_smoke writes (four zero-centred norms a
    layer, rectangular q/o, no lm_head: tied) loads into the same tree in
    both packages, with NF4 codes equal byte for byte, and gives the same
    logits (sliding and global layers, both softcaps), f32: 1e-4."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setenv("UNSLOTH_VALIDATE_CHECKPOINT", "0")
    chip_smoke.write_checkpoint(str(tmp_path), TINY_GEMMA2_HF)
    model, _ = FastLanguageModel.from_pretrained(
        str(tmp_path), load_in_4bit=True, dtype=torch.float32, device="cpu")
    jcfg = JConfig.from_hf_config(TINY_GEMMA2_HF)
    jparams = jloader.load_params(str(tmp_path), jcfg, dtype=jnp.float32,
                                  load_in_4bit=True)
    cfg = model.cfg
    assert cfg.tie_word_embeddings and "lm_head" not in model.params
    assert cfg.attn_logit_scale == pytest.approx(24 ** -0.5)
    assert (cfg.layer_kind(0), cfg.layer_kind(1)) == ("sliding", "global")
    jtree = jax.tree_util.tree_map(np.asarray, jparams)
    assert set(model.params) == set(jtree)
    for tl, jl in zip(model.params["layers"], jtree["layers"]):
        assert set(tl) == set(jl) == {
            "input_norm", "post_attn_out_norm", "pre_ffw_norm",
            "post_ffw_norm", "q", "k", "v", "o", "gate", "up", "down"}
        assert not tl["input_norm"].any()      # HF's init: zeros, (1 + w)
        assert tuple(tl["q"].shape) == (192, 128) and \
            tuple(tl["o"].shape) == (128, 192)
        np.testing.assert_array_equal(tl["q"].packed.numpy(),
                                      np.asarray(jl["q"].packed))
    ids = np.random.default_rng(0).integers(0, 300, (2, 40))
    want = np.asarray(jdec.logits_fn(jparams, None, jnp.asarray(ids), jcfg))
    got = tdec.logits_fn(model.params, None, _t(ids), cfg, remat=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


# ---------------------------------------------------------------------------
# (c) SFTTrainer(packing=False) on a tiny Gemma-2, against JAX
# ---------------------------------------------------------------------------

GEMMA2 = dict(model_type="gemma2", vocab_size=256, hidden_size=128,
              intermediate_size=256, num_layers=2, num_heads=4,
              num_kv_heads=2, max_position_embeddings=512, rms_norm_eps=1e-6,
              rope_theta=10000.0, hidden_act="gelu_tanh", gemma_norm=True,
              use_post_norms=True, embed_scale=128 ** 0.5, attn_softcap=50.0,
              final_softcap=30.0, sliding_window=32,
              layer_pattern=("sliding", "global"), tie_word_embeddings=True,
              attn_logit_scale=24 ** -0.5)
@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """Four steps of padded SFT (batch 2, accumulation 2) with
    train_on_responses_only from the same NF4 weights (quantized by JAX,
    carried byte for byte) and the same nonzero LoRA, in both packages,
    then evaluate on five held-out texts (a short last batch)."""
    jcfg, tcfg = JConfig(**GEMMA2), TConfig(**GEMMA2)
    jparams = quantize_params(init_params(jcfg, jax.random.PRNGKey(0),
                                          init_scale=0.05), jcfg,
                              dtype=jnp.float32)
    # zero-centred norms away from zero, so (1 + w) is exercised
    rng = np.random.default_rng(3)
    for layer in jparams["layers"]:
        for name in ("input_norm", "post_attn_out_norm", "pre_ffw_norm",
                     "post_ffw_norm"):
            layer[name] = jnp.asarray(rng.standard_normal(128) * 0.1,
                                      jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    lora = init_lora_tree(jcfg, jax.random.PRNGKey(1), r=4, alpha=8.0)
    for layer in lora["layers"]:
        for name, lw in list(layer.items()):
            b = rng.standard_normal(lw.b.shape).astype(np.float32) * 0.05
            layer[name] = LoRAWeights(lw.a, jnp.asarray(b), lw.scale)
    lora_np = jax.tree_util.tree_map(np.asarray, lora)

    tmp = tmp_path_factory.mktemp("gemma2")
    tok = ByteTokenizer()
    data, held_out = _alpaca_texts(16, 0), _alpaca_texts(5, 1)
    kw = dict(per_device_train_batch_size=2, gradient_accumulation_steps=2,
              max_steps=4, max_seq_length=T, warmup_steps=1,
              learning_rate=5e-3, logging_steps=1, packing=False)
    jmodel = JModel(cfg=jcfg, params=jparams, max_seq_length=T,
                    lora=jax.tree_util.tree_map(jnp.asarray, lora_np))
    jtr = jsft.SFTTrainer(jmodel, tokenizer=tok, train_dataset=data,
                          args=jsft.SFTConfig(output_dir=str(tmp / "j"), **kw))
    jsft.train_on_responses_only(jtr, instruction_part=INSTR,
                                 response_part=RESP)
    jsft.unsloth_train(jtr)
    jeval = jtr.evaluate(held_out)
    tmodel = TModel(cfg=tcfg, params=tparams, max_seq_length=T,
                    lora=lora_from_numpy(lora_np, "cpu"), gc_mode="offload")
    ttr = tsft.SFTTrainer(tmodel, tokenizer=tok, train_dataset=data,
                          args=tsft.SFTConfig(output_dir=str(tmp / "t"), **kw))
    tsft.train_on_responses_only(ttr, instruction_part=INSTR,
                                 response_part=RESP)
    tsft.unsloth_train(ttr)
    teval = ttr.evaluate(held_out)
    return jtr, ttr, jeval, teval


def test_gemma2_params_carried_across(trainers):
    """interop carries the JAX Gemma-2 tree whole: the sandwich norms, the
    tied embedding (no lm_head), NF4 codes byte for byte."""
    jtr, ttr, _, _ = trainers
    jtree = jax.tree_util.tree_map(np.asarray, jtr.model.params)
    tparams = ttr.model.params
    assert set(tparams) == set(jtree) == {"embed", "final_norm", "layers"}
    np.testing.assert_array_equal(tparams["embed"].numpy(), jtree["embed"])
    for tl, jl in zip(tparams["layers"], jtree["layers"]):
        assert set(tl) == set(jl)
        for name in ("post_attn_out_norm", "pre_ffw_norm", "post_ffw_norm"):
            np.testing.assert_array_equal(tl[name].numpy(), jl[name])
        np.testing.assert_array_equal(tl["down"].packed.numpy(),
                                      jl["down"].packed)


def test_gemma2_batches_match_jax(trainers):
    """Identical padded batches: ids, response-only labels, segment ids
    (1 real, 0 pad) and positions; rows longer than the window."""
    jtr, ttr, _, _ = trainers
    assert len(ttr._batches) == len(jtr._batches) == 8
    for jb, tb in zip(jtr._batches, ttr._batches):
        for name, a in jb.as_dict().items():
            np.testing.assert_array_equal(tb.as_dict()[name], np.asarray(a))
    seg = np.concatenate([b.segment_ids for b in ttr._batches])
    assert (seg != 0).sum(1).min() > GEMMA2["sliding_window"]


def test_gemma2_sft_losses_match_jax(trainers):
    """Per-step losses (1e-4 relative, f32 through AdamW updates) and
    learning rates; the trained adapters within 1e-3 relative L2."""
    jtr, ttr, _, _ = trainers
    assert len(ttr.state_log) == len(jtr.state_log) == 4
    for je, te in zip(jtr.state_log, ttr.state_log):
        np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-4)
        np.testing.assert_allclose(te["learning_rate"], je["learning_rate"],
                                   rtol=1e-6)
    trained = lora_to_numpy(ttr.model.lora)
    for jlayer, tlayer in zip(jtr.model.lora["layers"], trained["layers"]):
        for name, jw in jlayer.items():
            for part in ("a", "b"):
                want = np.asarray(getattr(jw, part))
                got = getattr(tlayer[name], part)
                assert np.linalg.norm(got - want) / np.linalg.norm(want) \
                    < 1e-3, (name, part)


def test_gemma2_evaluate_matches_jax(trainers):
    """eval_loss and eval_perplexity within 1e-4 relative; eval_tokens
    equal."""
    _, _, jeval, teval = trainers
    assert teval["eval_tokens"] == jeval["eval_tokens"] > 0
    for key in ("eval_loss", "eval_perplexity"):
        np.testing.assert_allclose(teval[key], jeval[key], rtol=1e-4)
