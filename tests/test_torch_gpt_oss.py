"""gpt-oss in the PyTorch port against the JAX package (and transformers),
on the CPU: a tiny HF ``GptOssForCausalLM`` checkpoint loaded by both
packages (sinks, alternating sliding/global layers, stacked interleaved
experts with biases, the router bias), attention with sinks on its global
and banded routes and the plain twin of K17, and, after ``quantize_params``
(NF4 attention, stacked-NF4 experts), the loss and LoRA gradients of a
packed row, three SFTTrainer steps, ``evaluate``, the adapter round trip
and a greedy generate; plus one tiny ``Qwen3MoeForCausalLM``. Each test
states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsloth_tpu.data.packing import batch_packed_rows, pack_sequences
from unsloth_tpu.models import decoder as jdec
from unsloth_tpu.models.config import ModelConfig as JConfig
from unsloth_tpu.models.loader import FastLanguageModel as JFast
from unsloth_tpu.models.loader import LanguageModel as JModel
from unsloth_tpu.models.params import (init_lora_tree, init_params,
                                       quantize_params)
from unsloth_tpu.ops.attention import attention_ref as jattention_ref
from unsloth_tpu.ops.lora import LoRAWeights
from unsloth_tpu.trainer import sft as jsft
from unsloth_tpu_torch import FastLanguageModel
from unsloth_tpu_torch.interop import (lora_from_numpy, lora_to_numpy,
                                       params_from_numpy)
from unsloth_tpu_torch.models import decoder as tdec
from unsloth_tpu_torch.models.config import ModelConfig as TConfig
from unsloth_tpu_torch.models.loader import LanguageModel as TModel
from unsloth_tpu_torch.ops import attention as tatt
from unsloth_tpu_torch.ops.flash_sinks import flash_sinks
from unsloth_tpu_torch.ops.nf4 import NF4Stacked
from unsloth_tpu_torch.trainer import sft as tsft

transformers = pytest.importorskip("transformers")

T = 512   # packed rows: 4 bands of 128, so the sliding layers take the
          # banded route (window 8) in both packages


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


TINY = dict(vocab_size=96, hidden_size=64, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, num_local_experts=4, num_experts_per_tok=2,
            sliding_window=8, max_position_embeddings=1024,
            tie_word_embeddings=False, pad_token_id=0)


def _save_hf(model, path):
    model.eval()
    model.save_pretrained(str(path), safe_serialization=True)
    return str(path)


@pytest.fixture(scope="module")
def gpt_oss_ckpt(tmp_path_factory):
    """A tiny HF gpt-oss checkpoint with every bias and the sinks drawn
    away from their zero init, so each reaches the logits."""
    from transformers import GptOssConfig, GptOssForCausalLM

    torch.manual_seed(0)
    hf = GptOssForCausalLM(GptOssConfig(**TINY))
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "bias" in name or "sinks" in name:
                p.normal_(0.0, 0.5)
    path = _save_hf(hf, tmp_path_factory.mktemp("gptoss"))
    return path, hf


def test_gpt_oss_checkpoint_logits_match_jax_and_hf(gpt_oss_ckpt, monkeypatch):
    """Both packages load the same tree (the experts de-interleaved into
    gate/up [E, F, D] and down [E, D, F] with their biases, the router and
    its bias, the sinks); f32 logits of a 40-token row (the window of 8
    bites): port against JAX within 1e-4, against transformers within
    1e-3 + 1e-2 relative (the JAX package's own bound)."""
    monkeypatch.setenv("UNSLOTH_VALIDATE_CHECKPOINT", "0")
    path, hf = gpt_oss_ckpt
    tm, _ = FastLanguageModel.from_pretrained(path, load_in_4bit=False,
                                              dtype=torch.float32,
                                              device="cpu")
    jm, _ = JFast.from_pretrained(path, load_in_4bit=False, dtype="float32")
    jtree = jax.tree_util.tree_map(np.asarray, jm.params)
    for tl, jl in zip(tm.params["layers"], jtree["layers"]):
        assert set(tl) == set(jl)
        assert {"sinks", "router", "router_bias", "experts"} <= set(tl)
        assert set(tl["experts"]) == set(jl["experts"]) == {
            "gate", "up", "down", "gate_bias", "up_bias", "down_bias"}
        for name, w in tl["experts"].items():
            np.testing.assert_array_equal(w.numpy(), jl["experts"][name])
    ids = (np.arange(1, 41).reshape(1, 40) * 7) % 96
    got = tdec.logits_fn(tm.params, None, _t(ids), tm.cfg,
                         remat=False).detach().numpy()
    want = np.asarray(jm.logits(jnp.asarray(ids, jnp.int32), remat=False))
    np.testing.assert_allclose(got, want, atol=1e-4)
    with torch.no_grad():
        hf_logits = hf(input_ids=torch.tensor(ids)).logits.numpy()
    np.testing.assert_allclose(got, hf_logits, atol=1e-3, rtol=1e-2)
    # sinks matter: pushed to -100 they drop out and the logits move
    for layer in tm.params["layers"]:
        layer["sinks"] = torch.full_like(layer["sinks"], -100.0)
    without = tdec.logits_fn(tm.params, None, _t(ids), tm.cfg,
                             remat=False).detach().numpy()
    assert np.abs(without - got).max() > 1e-3


def test_qwen3_moe_logits_match_jax_and_hf(tmp_path, monkeypatch):
    """A tiny Qwen3-MoE (softmax-top-k routing with norm_topk_prob, qk
    norms, per-expert tensors): the lifted check_supported takes it; f32
    logits against JAX within 1e-4 and transformers within 1e-3 + 1e-2
    relative."""
    from transformers import Qwen3MoeConfig, Qwen3MoeForCausalLM

    monkeypatch.setenv("UNSLOTH_VALIDATE_CHECKPOINT", "0")
    torch.manual_seed(1)
    hf = Qwen3MoeForCausalLM(Qwen3MoeConfig(
        vocab_size=96, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, num_experts=4,
        num_experts_per_tok=2, norm_topk_prob=True, decoder_sparse_step=1,
        max_position_embeddings=128, tie_word_embeddings=False))
    path = _save_hf(hf, tmp_path)
    tm, _ = FastLanguageModel.from_pretrained(path, load_in_4bit=False,
                                              dtype=torch.float32,
                                              device="cpu")
    assert tm.cfg.num_experts == 4 and "experts" in tm.params["layers"][0]
    jm, _ = JFast.from_pretrained(path, load_in_4bit=False, dtype="float32")
    ids = np.arange(1, 17).reshape(1, 16) % 96
    got = tdec.logits_fn(tm.params, None, _t(ids), tm.cfg,
                         remat=False).detach().numpy()
    want = np.asarray(jm.logits(jnp.asarray(ids, jnp.int32), remat=False))
    np.testing.assert_allclose(got, want, atol=1e-4)
    with torch.no_grad():
        hf_logits = hf(input_ids=torch.tensor(ids)).logits.numpy()
    np.testing.assert_allclose(got, hf_logits, atol=1e-3, rtol=1e-2)


# ---------------------------------------------------------------------------
# attention with sinks
# ---------------------------------------------------------------------------

def _attn_inputs(t, seed=0, hq=4, hkv=2, d=64):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((2, t, h, d)).astype(np.float32)
                     for h in (hq, hkv, hkv, hq))
    sinks = rng.standard_normal(hq).astype(np.float32)
    seg = np.zeros((2, t), np.int32)
    seg[0, :t - 40] = 1                         # a pad tail
    seg[1, :t // 3], seg[1, t // 3:] = 1, 2     # two packed segments
    return q, k, v, dout, sinks, seg


def _jax_ref(q, k, v, dout, sinks, seg, window):
    def f(q_, k_, v_, s_):
        return jattention_ref(q_, k_, v_, causal=True,
                              segment_ids=jnp.asarray(seg), window=window,
                              sinks=s_)

    args = [jnp.asarray(a) for a in (q, k, v, sinks)]
    out, vjp = jax.vjp(f, *args)
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _torch_grads(fn, q, k, v, dout, sinks):
    args = [_t(a).requires_grad_(True) for a in (q, k, v, sinks)]
    out = fn(*args)
    out.backward(_t(dout))
    return [out.detach().numpy()] + [a.grad.numpy() for a in args]


@pytest.mark.parametrize("route,t,window", [("global", 256, None),
                                            ("banded", 512, 128)])
def test_attention_sinks_matches_jax(route, t, window):
    """attention(..., sinks=) on the CPU (the reference on the global
    route, the banded form where a window of 128 is narrow at T = 512)
    against JAX's attention_ref: out and d(q, k, v, sinks), packed and
    padded rows, GQA 4/2 at head dim 64; f32, 1e-5 + 1e-5 relative."""
    q, k, v, dout, sinks, seg = _attn_inputs(t)
    want = _jax_ref(q, k, v, dout, sinks, seg, window)
    got = _torch_grads(lambda q_, k_, v_, s_: tatt.attention(
        q_, k_, v_, causal=True, segment_ids=_t(seg), window=window,
        sinks=s_), q, k, v, dout, sinks)
    for name, g, w in zip(("out", "dq", "dk", "dv", "dsinks"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)
    if route == "banded":   # the banded form, called as the dispatcher does
        band = _torch_grads(lambda q_, k_, v_, s_: tatt.banded_window_attention(
            q_, k_, v_, window=window, segment_ids=_t(seg), sinks=s_),
            q, k, v, dout, sinks)
        for g, w in zip(band, want):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_flash_sinks_plain_twin_matches_jax():
    """K17's plain twin (flash_sinks on CPU tensors: its forward and the
    backward the kernels compute, dsinks a plain reduction) against JAX's
    attention_ref with sinks: out, dq, dk, dv, dsinks; f32, 1e-5 + 1e-5
    relative."""
    q, k, v, dout, sinks, seg = _attn_inputs(200, seed=4)
    want = _jax_ref(q, k, v, dout, sinks, seg, None)
    got = _torch_grads(lambda q_, k_, v_, s_: flash_sinks(
        q_, k_, v_, s_, _t(seg)), q, k, v, dout, sinks)
    for name, g, w in zip(("out", "dq", "dk", "dv", "dsinks"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)


def test_apply_sinks_rescale_matches_reference():
    """The chunked lse and the rescale out * sigmoid(lse - sink) on an
    output computed without sinks equal the reference with sinks (f32,
    1e-5): the route of a window or softcap kernel."""
    q, k, v, _, sinks, seg = _attn_inputs(256, seed=5)
    qt, kt, vt, st, sgt = map(_t, (q, k, v, sinks, seg))
    plain = tatt.attention_ref(qt, kt, vt, segment_ids=sgt, window=100)
    lse = tatt._chunked_lse(qt, kt, causal=True, segment_ids=sgt,
                            window=100, softcap=None, scale=64 ** -0.5,
                            q_chunk=64)
    got = tatt._apply_sinks(plain, lse, st)
    want = tatt.attention_ref(qt, kt, vt, segment_ids=sgt, window=100,
                              sinks=st)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the training slice on a tiny quantized gpt-oss, against JAX
# ---------------------------------------------------------------------------

HF_TINY = dict(TINY, model_type="gpt_oss", num_hidden_layers=2,
               rope_theta=150000.0,
               rope_scaling={"rope_type": "yarn", "factor": 32.0,
                             "beta_fast": 32.0, "beta_slow": 1.0,
                             "original_max_position_embeddings": 4096,
                             "truncate": False})


def _docs(n, lo, hi, seed):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(3, 90, rng.randint(lo, hi)).tolist()}
            for _ in range(n)]


@pytest.fixture(scope="module")
def quantized_pair():
    """The tiny gpt-oss from JAX's init (biases and router bias drawn away
    from zero), quantize_params (NF4 q/k/v/o at block 64, experts stacked
    NF4 at block 32: in/2 = 32), carried byte for byte, and a nonzero
    LoRA on q/k/v/o (MoE layers have no expert LoRA)."""
    jcfg = JConfig.from_hf_config(HF_TINY)
    tcfg = TConfig.from_hf_config(HF_TINY)
    jp = init_params(jcfg, jax.random.PRNGKey(0), init_scale=0.1)
    rng = np.random.default_rng(7)
    for layer in jp["layers"]:
        for name in ("q_bias", "k_bias", "v_bias", "o_bias", "router_bias"):
            layer[name] = jnp.asarray(
                rng.standard_normal(layer[name].shape) * 0.1, jnp.float32)
        for name in ("gate_bias", "up_bias", "down_bias"):
            layer["experts"][name] = jnp.asarray(
                rng.standard_normal(layer["experts"][name].shape) * 0.1,
                jnp.float32)
    jp = quantize_params(jp, jcfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    lora = init_lora_tree(jcfg, jax.random.PRNGKey(1), r=4, alpha=8.0)
    assert all(set(layer) == {"q", "k", "v", "o"} for layer in lora["layers"])
    for layer in lora["layers"]:
        for name, lw in list(layer.items()):
            b = rng.standard_normal(lw.b.shape).astype(np.float32) * 0.05
            layer[name] = LoRAWeights(lw.a, jnp.asarray(b), lw.scale)
    return jcfg, tcfg, jp, tp, jax.tree_util.tree_map(np.asarray, lora)


def test_quantized_tree_carried(quantized_pair):
    _, tcfg, jp, tp, _ = quantized_pair
    for tl, jl in zip(tp["layers"], jp["layers"]):
        for name in ("gate", "up", "down"):
            w = tl["experts"][name]
            assert isinstance(w, NF4Stacked) and w.block_size == 32
            np.testing.assert_array_equal(w.packed.numpy(),
                                          np.asarray(jl["experts"][name].packed))


@pytest.fixture(scope="module")
def jax_packed_grads(quantized_pair):
    """Two packed rows of 512 and JAX's loss and LoRA grads on them (jitted;
    remat changes no value)."""
    jcfg, _, jp, _, lora_np = quantized_pair
    rows = pack_sequences(_docs(14, 30, 120, seed=0), T)
    batch = batch_packed_rows(rows, 2, T)[0].as_dict()
    fn = jax.jit(jax.value_and_grad(lambda lo, p, b: jdec.loss_fn(
        p, lo, b, jcfg, remat=False)))
    jl, jg = fn(jax.tree_util.tree_map(jnp.asarray, lora_np), jp,
                {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, jl, jg


@pytest.mark.parametrize("remat", [False, "offload"])
def test_packed_loss_and_lora_grads_match_jax(quantized_pair,
                                              jax_packed_grads, remat):
    """loss_fn on two packed rows of 512 (sliding layers banded, global
    layers the reference with sinks, the MoE through the grouped route and
    the NF4 experts' plain twin) and d loss / d every LoRA leaf; f32: loss
    within 1e-5 relative, each leaf within 1e-4 of its largest value."""
    _, tcfg, _, tp, lora_np = quantized_pair
    batch, jl, jg = jax_packed_grads
    tl_tree = lora_from_numpy(lora_np, "cpu")
    leaves = []
    for layer in tl_tree["layers"]:
        for lw in layer.values():
            leaves += [lw.a.requires_grad_(True), lw.b.requires_grad_(True)]
    with tatt.packed_segment_bound(120):
        loss = tdec.loss_fn(tp, tl_tree, {k: _t(v) for k, v in batch.items()},
                            tcfg, remat=remat)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for jlayer, tlayer in zip(jg["layers"], tl_tree["layers"]):
        for name, jw in jlayer.items():
            for part in ("a", "b"):
                want = np.asarray(getattr(jw, part))
                got = getattr(tlayer[name], part).grad.numpy()
                assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), \
                    (name, part)


@pytest.fixture(scope="module")
def trainers(quantized_pair, tmp_path_factory):
    """Three packed SFT steps (batch 1, accumulation 2) from the same NF4
    weights and LoRA in both packages, then evaluate on held-out
    documents."""
    jcfg, tcfg, jp, tp, lora_np = quantized_pair
    tmp = tmp_path_factory.mktemp("gptoss_sft")
    docs, held_out = _docs(30, 30, 200, seed=3), _docs(6, 30, 200, seed=4)
    kw = dict(per_device_train_batch_size=1, gradient_accumulation_steps=2,
              max_steps=3, max_seq_length=T, warmup_steps=1,
              learning_rate=5e-3, logging_steps=1)
    jmodel = JModel(cfg=jcfg, params=jp, max_seq_length=T,
                    lora=jax.tree_util.tree_map(jnp.asarray, lora_np))
    jtr = jsft.SFTTrainer(jmodel, train_dataset=docs, args=jsft.SFTConfig(
        output_dir=str(tmp / "j"), **kw))
    jtr.train()
    jeval = jtr.evaluate(held_out)
    tmodel = TModel(cfg=tcfg, params=tp, max_seq_length=T,
                    lora=lora_from_numpy(lora_np, "cpu"), gc_mode="offload",
                    lora_config={"r": 4, "lora_alpha": 8.0})
    ttr = tsft.SFTTrainer(tmodel, train_dataset=docs, args=tsft.SFTConfig(
        output_dir=str(tmp / "t"), **kw))
    ttr.train()
    teval = ttr.evaluate(held_out)
    return jtr, ttr, jeval, teval, held_out, tmp


def test_gpt_oss_sft_losses_match_jax(trainers):
    """Per-step losses within 1e-4 relative (f32 through AdamW updates) and
    learning rates; trained adapters within 1e-3 relative L2."""
    jtr, ttr, _, _, _, _ = trainers
    assert len(ttr.state_log) == len(jtr.state_log) == 3
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


def test_gpt_oss_evaluate_and_adapter_round_trip(trainers):
    """evaluate equals JAX's (1e-4 relative, equal token counts); after
    save_lora -> a fresh adapter (its loss differs) -> load_lora the eval
    loss is equal to the trained one's, exactly."""
    _, ttr, jeval, teval, held_out, tmp = trainers
    assert teval["eval_tokens"] == jeval["eval_tokens"] > 0
    np.testing.assert_allclose(teval["eval_loss"], jeval["eval_loss"],
                               rtol=1e-4)
    model = ttr.model
    model.save_lora(str(tmp / "adapter"))
    model.get_peft_model(r=2, lora_alpha=8, random_state=5)
    fresh = ttr.evaluate(held_out)
    assert fresh["eval_loss"] != teval["eval_loss"]
    model.load_lora(str(tmp / "adapter"))
    assert ttr.evaluate(held_out)["eval_loss"] == teval["eval_loss"]


def test_gpt_oss_greedy_generate_matches_jax(quantized_pair):
    """Greedy ids of 6 new tokens for two prompts (one past the window of
    8) through the KV cache with sinks and the MoE, f32: equal to JAX's."""
    jcfg, tcfg, jp, tp, _ = quantized_pair
    prompts = [[5, 9, 11, 3, 7], list(range(3, 15))]
    want = JModel(cfg=jcfg, params=jp).generate(
        prompts, max_new_tokens=6, temperature=0.0, return_token_ids=True)
    got = TModel(cfg=tcfg, params=tp).generate(
        prompts, max_new_tokens=6, temperature=0.0, return_token_ids=True)
    assert got == want and all(len(r) == 6 for r in got)


def test_moe_merged_save_raises(quantized_pair, tmp_path):
    """Saving merged MoE checkpoints is not ported: it raises instead of
    writing a checkpoint without its experts."""
    _, tcfg, _, tp, _ = quantized_pair
    with pytest.raises(NotImplementedError, match="MoE"):
        TModel(cfg=tcfg, params=tp).save_pretrained_merged(str(tmp_path))
