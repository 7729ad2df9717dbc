"""SFT without packing in the PyTorch port against the JAX package, on the
CPU: the plain twins of the full-logits CE kernels (K7/K8) and of the
unpacked flash attention (K16) against the JAX Pallas kernels in interpret
mode, the fused-CE gate, padded-row SFTTrainer with response-only labels
(batches, losses, evaluate), the peft adapter format in both directions,
and the merged 16-bit save."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from tests.helpers import make_hf_checkpoint
from unsloth_tpu.export import save as jsave
from unsloth_tpu.models.config import ModelConfig as JConfig
from unsloth_tpu.models.config import RopeScaling as JRope
from unsloth_tpu.models.loader import LanguageModel as JModel
from unsloth_tpu.models.params import (init_lora_tree, init_params,
                                       quantize_params)
from unsloth_tpu.ops.attention import _tpu_flash
from unsloth_tpu.ops import cross_entropy as jce
from unsloth_tpu.ops.lora import LoRAWeights
from unsloth_tpu.trainer import sft as jsft
from unsloth_tpu_torch import FastLanguageModel
from unsloth_tpu_torch.export import save as tsave
from unsloth_tpu_torch.interop import (lora_from_numpy, lora_to_numpy,
                                       params_from_numpy)
from unsloth_tpu_torch.models import decoder as tdec
from unsloth_tpu_torch.models.config import ModelConfig as TConfig
from unsloth_tpu_torch.models.config import RopeScaling as TRope
from unsloth_tpu_torch.models.loader import LanguageModel as TModel
from unsloth_tpu_torch.ops import attention as tatt
from unsloth_tpu_torch.ops import cross_entropy as tce
from unsloth_tpu_torch.ops import flash_attention as tfa
from unsloth_tpu_torch.trainer import sft as tsft


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# (a) full-logits CE: plain twins against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

# N not a multiple of the TPU's 256-row block, V not one of its 2,048-wide
# vocab block: both kernels mask a ragged edge
CE_N, CE_V = 300, 2500
CE_CASES = [(None, None), (30.0, None), (None, 0.5), (20.0, 0.25)]


def _ce_inputs(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((CE_N, CE_V)) * 4).astype(np.float32)
    labels = rng.integers(0, CE_V, CE_N).astype(np.int32)
    labels[rng.random(CE_N) < 0.3] = -100
    g = rng.random(CE_N).astype(np.float32)
    return logits, labels, g


@pytest.mark.parametrize("softcap,logit_scale", CE_CASES)
def test_ce_fwd_plain_matches_pallas(softcap, logit_scale):
    """(loss, lse) of the plain twin against _ce_fwd_pallas, f32: 1e-5
    relative (the kernel sums exp over 2,048-wide chunks online, the twin
    in one logsumexp)."""
    logits, labels, _ = _ce_inputs(0)
    want_loss, want_lse = jce._ce_fwd_pallas(
        jnp.asarray(logits), jnp.asarray(labels), softcap, logit_scale)
    loss, lse = tce.cross_entropy_ref(_t(logits), _t(labels), softcap,
                                          logit_scale)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               rtol=1e-5, atol=1e-5)
    assert (loss.numpy()[labels == -100] == 0).all()


@pytest.mark.parametrize("softcap,logit_scale", CE_CASES)
def test_ce_bwd_plain_matches_pallas(softcap, logit_scale):
    """dlogits of the plain twin against _ce_bwd_pallas from the same lse
    and per-row g, f32: 1e-6 absolute plus 1e-5 relative (the same
    elementwise formula; XLA's and torch's tanh differ in the last bits)."""
    logits, labels, g = _ce_inputs(1)
    _, lse = tce.cross_entropy_ref(_t(logits), _t(labels), softcap,
                                       logit_scale)
    want = jce._ce_bwd_pallas(jnp.asarray(logits), jnp.asarray(labels),
                              jnp.asarray(lse.numpy()), jnp.asarray(g),
                              softcap, logit_scale)
    got = tce.cross_entropy_bwd_ref(_t(logits), _t(labels), lse, _t(g),
                                    softcap, logit_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert (got.numpy()[labels == -100] == 0).all()


def test_fast_ce_loss_and_grad_match_jax():
    """fast_cross_entropy_loss and its logits gradient (the autograd
    Function over the plain twins) against JAX's custom_vjp, with n_items
    and a softcap, f32: 1e-5."""
    logits, labels, _ = _ce_inputs(2)
    n_items = 211.0

    def jloss(x):
        return jce.fast_cross_entropy_loss(x, jnp.asarray(labels),
                                           n_items=jnp.float32(n_items),
                                           softcap=30.0)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    got = tce.fast_cross_entropy_loss(x, _t(labels),
                                      n_items=torch.tensor(n_items),
                                      softcap=30.0)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-7)


# ---------------------------------------------------------------------------
# (b) K16: the plain twin against the bundled flash kernels (interpret)
# ---------------------------------------------------------------------------

def _padded_qkv(seed=0, b=2, t=256, hq=4, hkv=2, d=128, n_real=(256, 150)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    dout = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    seg = np.zeros((b, t), np.int32)
    for i, n in enumerate(n_real):
        seg[i, :n] = 1        # pad_batch: 1 = real, 0 = pad tail
    return q, k, v, dout, seg


@pytest.fixture(scope="module")
def jax_flash():
    """_tpu_flash (the bundled Pallas flash kernels, interpret mode) on a
    full and a padded row: out and d(sum out * dout)/d(q, k, v)."""
    q, k, v, dout, seg = _padded_qkv()
    scale = 128 ** -0.5

    def f(q_, k_, v_):
        return _tpu_flash(q_, k_, v_, causal=True,
                          segment_ids=jnp.asarray(seg), scale=scale)

    with pltpu.force_tpu_interpret_mode():
        out = f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(dout)),
                         argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    return (q, k, v, dout, seg), np.asarray(out), [np.asarray(x)
                                                   for x in grads]


def test_flash_plain_forward_matches_pallas(jax_flash):
    """Output at every position, pad queries included, f32: 1e-5."""
    (q, k, v, _, seg), want, _ = jax_flash
    got = tfa.flash_attention(_t(q), _t(k), _t(v), _t(seg))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_flash_plain_grads_match_pallas(jax_flash):
    """dq, dk, dv (GQA summed over each kv head's query heads) at every
    position, f32: 1e-4 of the largest value (fp32 sums in other orders)."""
    (q, k, v, dout, seg), _, want = jax_flash
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, _t(seg))
    torch.autograd.backward(out, _t(dout))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_flash_plain_matches_attention_ref_without_segments():
    """No segment ids, a ragged T (not a multiple of the 64-token tile):
    the twin equals the dispatcher's CPU route (attention_ref), f32."""
    q, k, v, _, _ = _padded_qkv(seed=3, b=1, t=100, n_real=(100,))
    got = tfa.flash_attention(_t(q), _t(k), _t(v))
    want = tatt.attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_tile_segment_ranges_ragged():
    seg = torch.tensor([[1] * 70 + [0] * 30])
    lo, hi = tfa.tile_segment_ranges(seg)
    assert lo.tolist() == [[1, 0]] and hi.tolist() == [[1, 1]]


def test_attention_check_rejects_faults():
    """chip_smoke's row-wise check of the attention kernels, on the plain
    twins (f32, one full and one padded row): the reference rounded to
    bf16 passes it, and a dropped kv tile, an ignored pad mask or a 10%
    error in the second half of a row fails it in each of out, dq, dk and
    dv."""
    q, k, v, dout, seg = (_t(x) for x in _padded_qkv(seed=5))
    scale = 128 ** -0.5
    out, lse = tfa.flash_attention_fwd_ref(q, k, v, seg, scale)
    want = (out,) + tfa.flash_attention_bwd_ref(q, k, v, seg, out, lse, dout,
                                                scale)
    for x in want:
        assert chip_smoke.attn_row_err(x.to(torch.bfloat16), x) <= \
            chip_smoke.ATTN_ROW_TOL
    res = chip_smoke.attn_fault_errs(q, k, v, seg, dout, scale, want)
    assert set(res) == {"kv tile dropped", "pad mask ignored",
                        "late half 10% off"}
    for fault, errs in res.items():
        assert set(errs) == {"out", "dq", "dk", "dv"}
        for name, (err, _) in errs.items():
            assert err > chip_smoke.ATTN_ROW_TOL, (fault, name, err)


# ---------------------------------------------------------------------------
# (c) the fused-CE gate
# ---------------------------------------------------------------------------

GIB = 1 << 30


@pytest.mark.parametrize("n_rows,total_memory,want_chunked", [
    (4094, 80 * 10**9, False),    # the notebook recipe: 2 x 2,048 rows
    (8191, 80 * 10**9, False),    # the packed headline: 1 x 8,192
    (8191, 16 * GIB, True),       # the same on the JAX package's chip
    (3000, 16 * GIB, False),      # fp32 logits <= 1.5 GiB: always full
    (65536, 80 * 10**9, True),    # 32 GiB of logits: chunked
])
def test_fused_ce_gate(n_rows, total_memory, want_chunked):
    """Llama-3.1-8B NF4 (5.97 GB of weights, 32 layers, hidden 4096,
    vocab 128,256): full logits while weights + layer boundaries + two
    fp32 logits buffers fit 27/32 of the card."""
    got = tdec.fused_ce_gate(n_rows, 128256, int(5.97e9), 32, 4096,
                             total_memory)
    assert got is want_chunked


def test_fused_ce_gate_is_full_off_cuda():
    h = torch.zeros((70000, 8))
    assert tdec._resolve_fused_ce({}, h, TConfig(vocab_size=128256)) is False


# ---------------------------------------------------------------------------
# (d) SFTTrainer(packing=False) with response-only labels, against JAX
# ---------------------------------------------------------------------------

BASE = dict(model_type="llama", vocab_size=256, hidden_size=128,
            intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
            max_position_embeddings=512, rms_norm_eps=1e-5,
            rope_theta=10000.0)
LLAMA3 = dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
              high_freq_factor=4.0, original_max_position_embeddings=64)
T = 128
INSTR, RESP = "### Instruction:\n", "\n### Response:\n"


class ByteTokenizer:
    """One UTF-8 byte is one token id."""

    pad_token_id = 0
    eos_token_id = None
    chat_template = None

    def __call__(self, text, **kw):
        return {"input_ids": list(text.encode("utf-8"))}


def _alpaca_texts(n, seed):
    """Alpaca-format texts of 60-170 bytes: some rows cut at T = 128."""
    rng = np.random.default_rng(seed)

    def chars(lo, hi):
        return "".join(chr(c) for c in rng.integers(97, 123, rng.integers(
            lo, hi + 1)))

    return [{"text": INSTR + chars(10, 40) + RESP + chars(20, 100)}
            for _ in range(n)]


def _nonzero_lora(cfg, seed=7):
    tree = init_lora_tree(cfg, jax.random.PRNGKey(1), r=4, alpha=8.0)
    rng = np.random.default_rng(seed)
    for layer in tree["layers"]:
        for name, lw in list(layer.items()):
            b = rng.standard_normal(lw.b.shape).astype(np.float32) * 0.05
            layer[name] = LoRAWeights(lw.a, jnp.asarray(b), lw.scale)
    return tree


@pytest.fixture(scope="module")
def model_pair():
    """JAX and torch configs, NF4 params quantized by JAX and carried byte
    for byte, and a LoRA tree with nonzero B (numpy leaves)."""
    jcfg = JConfig(**BASE, rope_scaling=JRope(**LLAMA3))
    tcfg = TConfig(**BASE, rope_scaling=TRope(**LLAMA3))
    jparams = quantize_params(init_params(jcfg, jax.random.PRNGKey(0)), jcfg,
                              dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    lora_np = jax.tree_util.tree_map(np.asarray, _nonzero_lora(jcfg))
    return jcfg, jparams, tcfg, tparams, lora_np


def _jax_lora(lora_np):
    return jax.tree_util.tree_map(jnp.asarray, lora_np)


@pytest.fixture(scope="module")
def trainers(model_pair, tmp_path_factory):
    """Four steps of padded SFT (batch 2, accumulation 2) with
    train_on_responses_only, from the same LoRA init, in both packages,
    then evaluate on six held-out texts (a short last batch)."""
    jcfg, jparams, tcfg, tparams, lora_np = model_pair
    tmp = tmp_path_factory.mktemp("unpacked")
    tok = ByteTokenizer()
    data, held_out = _alpaca_texts(16, 0), _alpaca_texts(5, 1)
    kw = dict(per_device_train_batch_size=2, gradient_accumulation_steps=2,
              max_steps=4, max_seq_length=T, warmup_steps=1,
              learning_rate=5e-3, logging_steps=1, packing=False)
    jmodel = JModel(cfg=jcfg, params=jparams, max_seq_length=T,
                    lora=_jax_lora(lora_np))
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


def test_unpacked_batches_and_labels_match_jax(trainers):
    """Identical padded batches: ids, response-only labels, segment ids
    (1 real, 0 pad) and positions; some rows are cut at T."""
    jtr, ttr, _, _ = trainers
    assert ttr._segment_bound is None and jtr._segment_bound is None
    assert len(ttr._batches) == len(jtr._batches) == 8
    for jb, tb in zip(jtr._batches, ttr._batches):
        for name, a in jb.as_dict().items():
            np.testing.assert_array_equal(tb.as_dict()[name], np.asarray(a))
    labels = np.concatenate([b.labels for b in ttr._batches])
    seg = np.concatenate([b.segment_ids for b in ttr._batches])
    assert (seg[:, -1] == 1).any() and (seg == 0).any()
    assert 0 < (labels != -100).sum() < (seg != 0).sum()


def test_unpacked_sft_losses_match_jax(trainers):
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


def test_unpacked_evaluate_matches_jax(trainers):
    """eval_loss and eval_perplexity within 1e-4 relative; eval_tokens
    equal (every label of the held-out texts counts: evaluate does not
    mask to responses, in either package)."""
    _, _, jeval, teval = trainers
    assert teval["eval_tokens"] == jeval["eval_tokens"] > 0
    for key in ("eval_loss", "eval_perplexity"):
        np.testing.assert_allclose(teval[key], jeval[key], rtol=1e-4)


def test_evaluate_needs_a_dataset(model_pair):
    _, _, tcfg, tparams, _ = model_pair
    tr = tsft.SFTTrainer(TModel(cfg=tcfg, params=tparams),
                         args=tsft.SFTConfig(max_seq_length=T))
    with pytest.raises(ValueError, match="no eval dataset"):
        tr.evaluate()


def test_response_masking_example_form():
    tok = ByteTokenizer()
    mask = tsft.train_on_responses_only(instruction_part=INSTR,
                                        response_part=RESP, tokenizer=tok)
    jmask = jsft.train_on_responses_only(instruction_part=INSTR,
                                         response_part=RESP, tokenizer=tok)
    text = INSTR + "ab" + RESP + "xyz" + INSTR + "c" + RESP + "w"
    ex = {"input_ids": tok(text)["input_ids"]}
    got = mask(ex)["labels"]
    assert got == jmask(ex)["labels"]
    kept = [chr(i) for i in got if i != -100]
    assert "".join(kept) == "xyzw"


# ---------------------------------------------------------------------------
# (e) the peft adapter format, both directions
# ---------------------------------------------------------------------------

def _assert_lora_equal(port_tree, jax_tree):
    for tlayer, jlayer in zip(port_tree["layers"], jax_tree["layers"]):
        assert set(tlayer) == set(jlayer)
        for name, jw in jlayer.items():
            assert tlayer[name].scale == pytest.approx(jw.scale)
            for part in ("a", "b"):
                np.testing.assert_array_equal(
                    getattr(tlayer[name], part).numpy(),
                    np.asarray(getattr(jw, part)))


def test_port_adapter_loads_in_jax(model_pair, tmp_path):
    jcfg, _, tcfg, tparams, lora_np = model_pair
    tmodel = TModel(cfg=tcfg, params=tparams, lora=lora_from_numpy(
        lora_np, "cpu"), lora_config={"r": 4, "lora_alpha": 8.0})
    tsave.save_lora(tmodel, str(tmp_path))
    jtree, lc = jsave.load_lora_tree(str(tmp_path), jcfg.num_layers)
    assert lc["r"] == 4 and lc["peft_type"] == "LORA"
    _assert_lora_equal(tmodel.lora, jtree)


def test_jax_adapter_loads_in_port(model_pair, tmp_path):
    jcfg, jparams, tcfg, tparams, lora_np = model_pair
    jmodel = JModel(cfg=jcfg, params=jparams, lora=_jax_lora(lora_np),
                    lora_config={"r": 4, "lora_alpha": 8.0})
    jsave.save_lora(jmodel, str(tmp_path))
    tmodel = TModel(cfg=tcfg, params=tparams)
    tmodel.load_lora(str(tmp_path))
    assert tmodel.lora_config["lora_alpha"] == 8.0
    _assert_lora_equal(tmodel.lora, jmodel.lora)


# ---------------------------------------------------------------------------
# (f) merged weights and the merged 16-bit save
# ---------------------------------------------------------------------------

def test_merged_params_match_jax(model_pair):
    """Every merged (or dequantized) projection equals JAX's bf16 result
    within one bf16 rounding (fp32 B @ A summed in another order can flip
    the last bit); norms and embeddings are the same tensors."""
    jcfg, jparams, tcfg, tparams, lora_np = model_pair
    want = jsave.merged_params(JModel(cfg=jcfg, params=jparams,
                                      lora=_jax_lora(lora_np)))
    got = tsave.merged_params(TModel(cfg=tcfg, params=tparams,
                                     lora=lora_from_numpy(lora_np, "cpu")))
    for jlayer, tlayer in zip(want["layers"], got["layers"]):
        assert set(jlayer) == set(tlayer)
        for name, w in jlayer.items():
            ref = np.asarray(jnp.asarray(w, jnp.float32))
            out = tlayer[name].to(torch.float32).numpy()
            assert np.all(np.abs(out - ref) <= 2.0 ** -8 * np.abs(ref)
                          + 1e-9), name


def _nf4_lora_model(tmp_path):
    """A tiny HF checkpoint loaded in NF4 (fp32 compute) with LoRA on the
    seven projections, B nonzero."""
    cfg = dict(model_type="llama", architectures=["LlamaForCausalLM"],
               vocab_size=256, hidden_size=128, intermediate_size=256,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=256,
               rms_norm_eps=1e-5, rope_theta=10000.0,
               tie_word_embeddings=False)
    src = str(tmp_path / "src")
    make_hf_checkpoint(src, cfg)
    model, _ = FastLanguageModel.from_pretrained(
        src, load_in_4bit=True, dtype=torch.float32, device="cpu")
    model = model.get_peft_model(r=4, lora_alpha=8)
    gen = torch.Generator().manual_seed(0)
    for layer in model.lora["layers"]:
        for lw in layer.values():
            lw.b = torch.randn(lw.b.shape, generator=gen) * 0.05
    return model


def test_merged_16bit_save_reloads_to_lora_logits(tmp_path):
    """The NF4 + LoRA model saved merged, reloaded with load_in_4bit=False:
    the reloaded model's logits against the LoRA model's, rel. L2 <= 1e-2
    (the merged weights are rounded to bf16 once, about 2^-9 relative
    each)."""
    model = _nf4_lora_model(tmp_path)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 32)))
    want = tdec.logits_fn(model.params, model.lora, ids, model.cfg,
                          remat=False)
    out = str(tmp_path / "merged")
    model.save_pretrained_merged(out)
    assert os.path.exists(os.path.join(out, "model.safetensors"))
    merged, _ = FastLanguageModel.from_pretrained(
        out, load_in_4bit=False, dtype=torch.float32, device="cpu")
    got = tdec.logits_fn(merged.params, None, ids, merged.cfg, remat=False)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-2, rel
    no_lora = tdec.logits_fn(model.params, None, ids, model.cfg, remat=False)
    assert ((no_lora - want).norm() / want.norm()).item() > 10 * rel


def test_merged_save_writes_merged_params(tmp_path):
    """The save merges each projection as it is written; what it writes
    is exactly :func:`merged_params` (bf16), every tensor of the tree."""
    model = _nf4_lora_model(tmp_path)
    out = str(tmp_path / "merged")
    model.save_pretrained_merged(out)
    saved, _ = FastLanguageModel.from_pretrained(
        out, load_in_4bit=False, dtype=torch.float32, device="cpu")
    want = tsave.merged_params(model)
    for key in ("embed", "final_norm", "lm_head"):
        assert torch.equal(saved.params[key],
                           want[key].to(torch.bfloat16).float()), key
    for wl, sl in zip(want["layers"], saved.params["layers"]):
        assert set(wl) == set(sl)
        for name, w in wl.items():
            assert torch.equal(sl[name], w.to(torch.bfloat16).float()), name
