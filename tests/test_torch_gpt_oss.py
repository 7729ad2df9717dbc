"""gpt-oss in the PyTorch port against the JAX package (and transformers),
on the CPU: a tiny HF ``GptOssForCausalLM`` checkpoint loaded by both
packages (sinks, alternating sliding/global layers, stacked interleaved
experts with biases, the router bias), and its MXFP4 form; attention with
sinks on its global and banded routes and the plain twin of K17; the
loss and LoRA gradients of a packed row and three SFTTrainer steps with
dense experts (the tree ``from_pretrained(load_in_4bit=True)`` leaves: NF4
attention, dense expert stacks through K19's plain version) and, after
``quantize_params`` (stacked-NF4 experts), the same plus ``evaluate``, the
adapter round trip and a greedy generate; ``merged_params``,
``tree_bytes`` and the merged save of MoE trees; plus one tiny
``Qwen3MoeForCausalLM``. Each test states its tolerance."""

import os


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsloth_tpu.data.packing import batch_packed_rows, pack_sequences
from unsloth_tpu.export import save as jsave
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
from unsloth_tpu_torch.export import save as tsave
from unsloth_tpu_torch.interop import (lora_from_numpy, lora_to_numpy,
                                       params_from_numpy)
from unsloth_tpu_torch.io_safetensors import SafetensorsFile, save_file
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


def _pair(skip=()):
    """The tiny gpt-oss from JAX's init (biases and router bias drawn away
    from zero), quantize_params (NF4 q/k/v/o at block 64 and, unless
    ``skip`` names them, experts stacked NF4 at block 32: in/2 = 32),
    carried byte for byte, and a nonzero LoRA on q/k/v/o (MoE layers have
    no expert LoRA)."""
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
    jp = quantize_params(jp, jcfg, dtype=jnp.float32, skip=skip)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    lora = init_lora_tree(jcfg, jax.random.PRNGKey(1), r=4, alpha=8.0)
    assert all(set(layer) == {"q", "k", "v", "o"} for layer in lora["layers"])
    for layer in lora["layers"]:
        for name, lw in list(layer.items()):
            b = rng.standard_normal(lw.b.shape).astype(np.float32) * 0.05
            layer[name] = LoRAWeights(lw.a, jnp.asarray(b), lw.scale)
    return jcfg, tcfg, jp, tp, jax.tree_util.tree_map(np.asarray, lora)


@pytest.fixture(scope="module")
def quantized_pair():
    """:func:`_pair` with stacked-NF4 experts."""
    return _pair()


@pytest.fixture(scope="module")
def dense_pair():
    """:func:`_pair` with the experts left dense (fp32 here), as
    ``from_pretrained(load_in_4bit=True)`` leaves them in both packages:
    the port's grouped route runs K19's plain version on them, JAX's its
    dense oracle off the TPU."""
    return _pair(skip=("experts",))


def test_quantized_tree_carried(quantized_pair):
    _, tcfg, jp, tp, _ = quantized_pair
    for tl, jl in zip(tp["layers"], jp["layers"]):
        for name in ("gate", "up", "down"):
            w = tl["experts"][name]
            assert isinstance(w, NF4Stacked) and w.block_size == 32
            np.testing.assert_array_equal(w.packed.numpy(),
                                          np.asarray(jl["experts"][name].packed))


def _jax_packed_grads(pair):
    """Two packed rows of 512 and JAX's loss and LoRA grads on them (jitted;
    remat changes no value)."""
    jcfg, _, jp, _, lora_np = pair
    rows = pack_sequences(_docs(14, 30, 120, seed=0), T)
    batch = batch_packed_rows(rows, 2, T)[0].as_dict()
    fn = jax.jit(jax.value_and_grad(lambda lo, p, b: jdec.loss_fn(
        p, lo, b, jcfg, remat=False)))
    jl, jg = fn(jax.tree_util.tree_map(jnp.asarray, lora_np), jp,
                {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, jl, jg


@pytest.fixture(scope="module")
def jax_packed_grads(quantized_pair):
    return _jax_packed_grads(quantized_pair)


def _check_packed_loss_and_grads(pair, jax_grads, remat):
    _, tcfg, _, tp, lora_np = pair
    batch, jl, jg = jax_grads
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


@pytest.mark.parametrize("remat", [False, "offload"])
def test_packed_loss_and_lora_grads_match_jax(quantized_pair,
                                              jax_packed_grads, remat):
    """loss_fn on two packed rows of 512 (sliding layers banded, global
    layers the reference with sinks, the MoE through the grouped route and
    the NF4 experts' plain twin) and d loss / d every LoRA leaf; f32: loss
    within 1e-5 relative, each leaf within 1e-4 of its largest value."""
    _check_packed_loss_and_grads(quantized_pair, jax_packed_grads, remat)


@pytest.mark.parametrize("remat", [False, "offload"])
def test_dense_experts_packed_loss_and_lora_grads_match_jax(dense_pair,
                                                            remat):
    """The same with dense experts, the tree from_pretrained(load_in_4bit=
    True) leaves: the port's grouped route through gmm (K19's plain version
    on the CPU) against JAX's MoE (its dense oracle off the TPU); f32: loss
    within 1e-5 relative, each leaf within 1e-4 of its largest value."""
    assert all(isinstance(w, torch.Tensor)
               for layer in dense_pair[3]["layers"]
               for w in layer["experts"].values())
    _check_packed_loss_and_grads(dense_pair, _jax_packed_grads(dense_pair),
                                 remat)


def _sft_pair(pair, tmp):
    """Three packed SFT steps (batch 1, accumulation 2) from the same
    weights and LoRA in both packages."""
    jcfg, tcfg, jp, tp, lora_np = pair
    docs = _docs(30, 30, 200, seed=3)
    kw = dict(per_device_train_batch_size=1, gradient_accumulation_steps=2,
              max_steps=3, max_seq_length=T, warmup_steps=1,
              learning_rate=5e-3, logging_steps=1)
    jmodel = JModel(cfg=jcfg, params=jp, max_seq_length=T,
                    lora=jax.tree_util.tree_map(jnp.asarray, lora_np))
    jtr = jsft.SFTTrainer(jmodel, train_dataset=docs, args=jsft.SFTConfig(
        output_dir=str(tmp / "j"), **kw))
    jtr.train()
    tmodel = TModel(cfg=tcfg, params=tp, max_seq_length=T,
                    lora=lora_from_numpy(lora_np, "cpu"), gc_mode="offload",
                    lora_config={"r": 4, "lora_alpha": 8.0})
    ttr = tsft.SFTTrainer(tmodel, train_dataset=docs, args=tsft.SFTConfig(
        output_dir=str(tmp / "t"), **kw))
    ttr.train()
    return jtr, ttr


@pytest.fixture(scope="module")
def trainers(quantized_pair, tmp_path_factory):
    """:func:`_sft_pair` on the NF4 experts, then evaluate on held-out
    documents."""
    tmp = tmp_path_factory.mktemp("gptoss_sft")
    held_out = _docs(6, 30, 200, seed=4)
    jtr, ttr = _sft_pair(quantized_pair, tmp)
    jeval = jtr.evaluate(held_out)
    teval = ttr.evaluate(held_out)
    return jtr, ttr, jeval, teval, held_out, tmp


def _check_sft_match(jtr, ttr):
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


def test_gpt_oss_sft_losses_match_jax(trainers):
    """Per-step losses within 1e-4 relative (f32 through AdamW updates) and
    learning rates; trained adapters within 1e-3 relative L2."""
    jtr, ttr, _, _, _, _ = trainers
    _check_sft_match(jtr, ttr)


def test_dense_experts_sft_losses_match_jax(dense_pair, tmp_path):
    """The three SFT steps with dense experts (the default MoE path: no
    quantize_params); the same tolerances."""
    _check_sft_match(*_sft_pair(dense_pair, tmp_path))


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


# ---------------------------------------------------------------------------
# MXFP4 checkpoints, merged weights and the merged save of MoE trees
# ---------------------------------------------------------------------------

def test_mxfp4_dequant_bit_equal_jax():
    """dequantize_mxfp4 equals JAX's bit for bit over every nibble and
    scales from 2^-127 (subnormal results) to 2^73."""
    from unsloth_tpu.models.mxfp4 import dequantize_mxfp4 as jdequant
    from unsloth_tpu_torch.models.mxfp4 import dequantize_mxfp4

    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, (3, 5, 4, 16)).astype(np.uint8)
    scales = rng.integers(0, 201, (3, 5, 4)).astype(np.uint8)
    scales[0, 0] = [0, 1, 127, 200]
    got = dequantize_mxfp4(_t(blocks), _t(scales)).numpy()
    want = jdequant(blocks, scales)
    assert got.shape == want.shape == (3, 5, 128)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_gpt_oss_mxfp4_checkpoint_matches_jax(gpt_oss_ckpt, tmp_path,
                                               monkeypatch):
    """The tiny checkpoint with its expert weights replaced by MXFP4 blocks
    and scales (built offline as tests/test_bnb_interop.py builds one, with
    a spread of scales): both packages load the same tree, exactly, and
    every expert weight is JAX's dequantization of the blocks, de-interleaved
    and transposed; f32 logits within 1e-4 of JAX's."""
    from unsloth_tpu.models.mxfp4 import dequantize_mxfp4 as jdequant

    monkeypatch.setenv("UNSLOTH_VALIDATE_CHECKPOINT", "0")
    src, _ = gpt_oss_ckpt
    f = SafetensorsFile(os.path.join(src, "model.safetensors"))
    tensors = {name: f.get(name) for name in f.keys()}
    rng = np.random.default_rng(1)
    quant = str(tmp_path / "mxfp4")
    os.makedirs(quant)
    for fname in os.listdir(src):
        if fname.endswith(".json"):
            with open(os.path.join(src, fname)) as fin, \
                    open(os.path.join(quant, fname), "w") as fout:
                fout.write(fin.read())
    blocks_np = {}
    for i in range(TINY["num_hidden_layers"]):
        p = f"model.layers.{i}.mlp.experts."
        for name in ("gate_up_proj", "down_proj"):
            e_dim, in_dim, out_dim = tensors.pop(p + name).shape
            blocks = rng.integers(0, 256, (e_dim, out_dim, in_dim // 32, 16)
                                  ).astype(np.uint8)
            scales = rng.integers(122, 130, (e_dim, out_dim, in_dim // 32)
                                  ).astype(np.uint8)
            blocks_np[p + name] = (blocks, scales)
            tensors[p + name + "_blocks"] = _t(blocks)
            tensors[p + name + "_scales"] = _t(scales)
    save_file(tensors, os.path.join(quant, "model.safetensors"))

    tm, _ = FastLanguageModel.from_pretrained(quant, load_in_4bit=False,
                                              dtype=torch.float32,
                                              device="cpu")
    jm, _ = JFast.from_pretrained(quant, load_in_4bit=False, dtype="float32")
    jtree = jax.tree_util.tree_map(np.asarray, jm.params)
    for i, (tl, jl) in enumerate(zip(tm.params["layers"], jtree["layers"])):
        assert set(tl["experts"]) == set(jl["experts"]) == {
            "gate", "up", "down", "gate_bias", "up_bias", "down_bias"}
        for name, w in tl["experts"].items():
            np.testing.assert_array_equal(w.numpy(), jl["experts"][name])
        p = f"model.layers.{i}.mlp.experts."
        gup = jdequant(*blocks_np[p + "gate_up_proj"]).transpose(0, 2, 1)
        np.testing.assert_array_equal(tl["experts"]["gate"].numpy(),
                                      gup[:, :, 0::2].transpose(0, 2, 1))
        np.testing.assert_array_equal(tl["experts"]["up"].numpy(),
                                      gup[:, :, 1::2].transpose(0, 2, 1))
        np.testing.assert_array_equal(
            tl["experts"]["down"].numpy(),
            jdequant(*blocks_np[p + "down_proj"]))
    ids = (np.arange(1, 25).reshape(1, 24) * 5) % 96
    got = tdec.logits_fn(tm.params, None, _t(ids), tm.cfg,
                         remat=False).detach().numpy()
    want = np.asarray(jm.logits(jnp.asarray(ids, jnp.int32), remat=False))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_merged_params_dequantizes_moe_experts_as_jax(quantized_pair):
    """merged_params on the NF4 MoE tree with its LoRA: stacked-NF4 experts
    dequantized to bf16 exactly as JAX's (fault C1: they used to pass
    through quantized), expert biases unchanged, merged projections within
    one bf16 rounding of JAX's (fp32 B @ A in another order)."""
    jcfg, tcfg, jp, tp, lora_np = quantized_pair
    want = jsave.merged_params(JModel(cfg=jcfg, params=jp, lora=jax.tree_util
                                      .tree_map(jnp.asarray, lora_np)))
    got = tsave.merged_params(TModel(cfg=tcfg, params=tp,
                                     lora=lora_from_numpy(lora_np, "cpu")))
    for jlayer, tlayer in zip(want["layers"], got["layers"]):
        assert set(jlayer) == set(tlayer)
        for name, w in jlayer["experts"].items():
            out = tlayer["experts"][name]
            assert isinstance(out, torch.Tensor), name
            if name in ("gate", "up", "down"):
                assert out.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(
                out.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32)))
        for name in ("q", "k", "v", "o"):
            ref = np.asarray(jnp.asarray(jlayer[name], jnp.float32))
            out = tlayer[name].float().numpy()
            assert np.all(np.abs(out - ref) <= 2.0 ** -8 * np.abs(ref)
                          + 1e-9), name


@pytest.mark.parametrize("pair", ["quantized", "dense"])
def test_tree_bytes_counts_moe_trees_as_jax(pair, request):
    """tree_bytes (the fused_ce="auto" gate's weight bytes) equals JAX's sum
    over the tree's leaves, stacked-NF4 experts included (fault C2: they
    counted 0 bytes)."""
    _, _, jp, tp, _ = request.getfixturevalue(pair + "_pair")
    want = sum(x.size * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(jp) if hasattr(x, "dtype"))
    assert tdec.tree_bytes(tp) == want
    experts = tp["layers"][0]["experts"]
    assert tdec.tree_bytes(experts["gate"]) > 0


def _saved_tensors(path):
    """{name: (dtype, shape, raw bytes)} of a checkpoint directory's
    safetensors files."""
    import json
    import struct

    out = {}
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".safetensors"):
            continue
        with open(os.path.join(path, fname), "rb") as fh:
            (n,) = struct.unpack("<Q", fh.read(8))
            header = json.loads(fh.read(n))
            data = fh.read()
        header.pop("__metadata__", None)
        for name, meta in header.items():
            lo, hi = meta["data_offsets"]
            out[name] = (meta["dtype"], tuple(meta["shape"]), data[lo:hi])
    return out


def _merged_saves(path, tmp_path, quantize):
    """Both packages' from_pretrained(load_in_4bit=True) of ``path`` (fp32
    compute), optionally quantize_params, then save_pretrained_merged;
    returns (port model, JAX model, port dir, JAX dir)."""
    tm, _ = FastLanguageModel.from_pretrained(path, load_in_4bit=True,
                                              dtype=torch.float32,
                                              device="cpu")
    jm, _ = JFast.from_pretrained(path, load_in_4bit=True, dtype="float32")
    if quantize:
        from unsloth_tpu_torch.models.params import \
            quantize_params as tquantize
        tm.params = tquantize(tm.params, tm.cfg, dtype=torch.float32)
        jm.params = quantize_params(jm.params, jm.cfg, dtype=jnp.float32)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    tm.save_pretrained_merged(tdir)
    jm.save_pretrained_merged(jdir)
    return tm, jm, tdir, jdir


def test_qwen3_moe_merged_save_matches_jax(tmp_path, monkeypatch):
    """A tiny Qwen3-MoE loaded in 4 bit, its experts quantized by
    quantize_params (gate/up stacked NF4 at block 32; down, in = 32, stays
    dense), saved merged by both packages: the same tensor names, dtypes,
    shapes and bytes (one tensor per expert and projection), and the
    checkpoint loads back in the port to exactly merged_params' tree."""
    from transformers import Qwen3MoeConfig, Qwen3MoeForCausalLM

    monkeypatch.setenv("UNSLOTH_VALIDATE_CHECKPOINT", "0")
    torch.manual_seed(2)
    hf = Qwen3MoeForCausalLM(Qwen3MoeConfig(
        vocab_size=96, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, num_experts=4,
        num_experts_per_tok=2, norm_topk_prob=True, decoder_sparse_step=1,
        max_position_embeddings=128, tie_word_embeddings=False))
    src = _save_hf(hf, tmp_path / "src")
    tm, _, tdir, jdir = _merged_saves(src, tmp_path, quantize=True)
    experts = tm.params["layers"][0]["experts"]
    assert isinstance(experts["gate"], NF4Stacked)
    assert isinstance(experts["down"], torch.Tensor)
    got, want = _saved_tensors(tdir), _saved_tensors(jdir)
    assert set(got) == set(want)
    assert "model.layers.1.mlp.experts.3.down_proj.weight" in got
    for name, meta in want.items():
        assert got[name] == meta, name
    back, _ = FastLanguageModel.from_pretrained(tdir, load_in_4bit=False,
                                                dtype=torch.float32,
                                                device="cpu")
    merged = tsave.merged_params(tm)
    for ml, bl in zip(merged["layers"], back.params["layers"]):
        assert set(ml) == set(bl)
        for name, w in ml["experts"].items():
            assert torch.equal(bl["experts"][name],
                               w.to(torch.bfloat16).float()), name


def test_gpt_oss_merged_save_matches_jax_file(gpt_oss_ckpt, tmp_path,
                                              monkeypatch):
    """gpt-oss saved merged (experts dense, as from_pretrained leaves them)
    by both packages: the same names and bytes, as JAX writes them: the
    experts one tensor per expert under the qwen3-moe names and no expert
    biases (a reference-side issue, kept for parity). So the checkpoint
    loads back, in both packages, without its expert biases."""
    monkeypatch.setenv("UNSLOTH_VALIDATE_CHECKPOINT", "0")
    src, _ = gpt_oss_ckpt
    tm, _, tdir, jdir = _merged_saves(src, tmp_path, quantize=False)
    got, want = _saved_tensors(tdir), _saved_tensors(jdir)
    assert set(got) == set(want)
    for name, meta in want.items():
        assert got[name] == meta, name
    assert "model.layers.0.mlp.experts.3.gate_proj.weight" in got
    assert not any("experts" in n and ("bias" in n or "gate_up" in n)
                   for n in got)
    back, _ = FastLanguageModel.from_pretrained(tdir, load_in_4bit=False,
                                                dtype=torch.float32,
                                                device="cpu")
    jback, _ = JFast.from_pretrained(tdir, load_in_4bit=False,
                                     dtype="float32")
    assert set(back.params["layers"][0]["experts"]) == \
        set(jback.params["layers"][0]["experts"]) == {"gate", "up", "down"}
    assert set(tm.params["layers"][0]["experts"]) > {"gate", "up", "down"}
