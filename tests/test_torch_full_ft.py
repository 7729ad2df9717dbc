"""Full fine-tuning in the PyTorch port against the JAX package, on the CPU.

The expert weight gradient (K19 tgmm's plain version, and gmm's backward)
against ``jax.grad`` of megablox ``gmm`` in interpret mode, routed as
JAX's ``tiled_gmm`` routes it; the grouped MoE MLP's gradients to the
experts, their biases and the router against ``jax.grad`` of JAX's
``moe_mlp_grouped``; the decoder's full-FT loss and every param's
gradient under each remat; ``SFTTrainer`` with no LoRA tree on a tiny
llama (untied and tied) and a tiny gpt-oss, one and two steps, losses and
every param leaf against the JAX trainer; checkpoint saves and resume
(the port's versions of tests/test_checkpoint_resume.py);
``modules_to_save`` and ``embedding_learning_rate`` (of
tests/test_embedding_lr.py) against JAX; GaLore and Q-GaLore against
JAX's optax transforms (and the port's versions of
tests/test_optimizer_galore.py); the loader's notebook keywords and hub
names (C8, C9); the merged save after full fine-tuning; and the GRPO
phase's method patching in chip_smoke.py leaving no reference cycle (C7).

Inputs come from numpy with a seed. Tolerances, unless a test says
otherwise: fp32 throughout; losses 1e-5 relative; a param after an
optimizer step within 2e-4 absolute plus 1e-4 relative (AdamW's first
steps move every element by about the learning rate, 1e-3 here, whatever
its gradient's size, so an element whose gradient is at the level of the
other package's rounding moves by a visibly different fraction of a step);
gradients within 1e-4 of the leaf's largest value.
"""

import gc
import importlib
import json
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import TINY_LLAMA, make_hf_checkpoint
from tests.test_torch_gmm import CASES, jax_tiled_gmm
from unsloth_tpu.models import decoder as jdec
from unsloth_tpu.models.loader import FastLanguageModel as JFast
from unsloth_tpu.trainer import sft as jsft
from unsloth_tpu_torch import FastLanguageModel
from unsloth_tpu_torch.interop import params_from_numpy, params_to_numpy
from unsloth_tpu_torch.io_safetensors import SafetensorsFile
from unsloth_tpu_torch.models import decoder as tdec
from unsloth_tpu_torch.ops import gmm as tgmm
from unsloth_tpu_torch.trainer import checkpoint as tckpt
from unsloth_tpu_torch.trainer import sft as tsft

jgalore = importlib.import_module("unsloth_tpu.optimizers.galore")
tgalore = importlib.import_module("unsloth_tpu_torch.optimizers.galore")

STEP_TOL = dict(atol=2e-4, rtol=1e-4)
GRAD_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_leaves(tree, prefix=""):
    """{path: numpy} of a JAX tree, paths as checkpoint.named_leaves names
    them."""
    if isinstance(tree, dict):
        return {n: v for k in sorted(tree)
                for n, v in _jax_leaves(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {n: v for i, x in enumerate(tree)
                for n, v in _jax_leaves(x, f"{prefix}{i}.").items()}
    if hasattr(tree, "a") and hasattr(tree, "b"):
        return {prefix + "a": np.asarray(tree.a),
                prefix + "b": np.asarray(tree.b)}
    return {prefix[:-1]: np.asarray(tree)}


def _assert_trees_close(ttree, jtree, **tol):
    want = _jax_leaves(jtree)
    got = tckpt.named_leaves(ttree)
    assert {n for n, _ in got} == set(want)
    for name, t in got:
        np.testing.assert_allclose(t.detach().numpy(), want[name],
                                   err_msg=name, **tol)


def _docs(n, vocab, seed, lo=10, hi=40):
    r = np.random.RandomState(seed)
    return [{"input_ids": r.randint(3, vocab - 3, r.randint(lo, hi)).tolist()}
            for _ in range(n)]


# ---------------------------------------------------------------------------
# K19 tgmm and the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_tgmm_matches_megablox_grad(case):
    """tgmm_ref, and gmm's backward with trainable W and bias on CPU
    tensors, against jax.grad of the tiled_gmm route (megablox gmm in
    interpret mode, K and N padded to 128) with respect to W and the
    bias: empty groups, a skewed routing, one expert; 1e-5 relative plus
    1e-5 absolute (the same fp32 products summed in another order)."""
    e, n, k, sizes = CASES[case]
    rng = np.random.default_rng(e * 10 + k)
    m = sum(sizes)
    w = (rng.standard_normal((e, n, k)) * 0.1).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    bias = rng.standard_normal((e, n)).astype(np.float32)
    js = jnp.asarray(np.asarray(sizes, np.int32))
    want_w, want_b = jax.grad(
        lambda w_, b_: jnp.sum(jax_tiled_gmm(jnp.asarray(x), w_, js, b_)
                               * jnp.asarray(g)), argnums=(0, 1))(
        jnp.asarray(w), jnp.asarray(bias))
    ts = _t(np.asarray(sizes, np.int32))
    np.testing.assert_allclose(tgmm.tgmm_ref(_t(x), _t(g), ts).numpy(),
                               np.asarray(want_w), rtol=1e-5, atol=1e-5)
    tw = _t(w).requires_grad_(True)
    tb = _t(bias).requires_grad_(True)
    tgmm.gmm(_t(x), tw, ts, tb).backward(_t(g))
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_w),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_b),
                               rtol=1e-5, atol=1e-5)
    empty = [i for i, s in enumerate(sizes) if not s]
    assert all(not tw.grad[i].any() for i in empty)


def test_moe_grouped_grads_match_jax():
    """The port's grouped MoE MLP (dense experts with biases, softmax-top-k
    with renormalized weights, gpt-oss's GLU) under autograd against
    jax.grad of JAX's moe_mlp_grouped (megablox in interpret mode, so its
    weight gradients run tgmm) with respect to the input, the router and
    its bias, the three expert stacks and their biases: nothing is
    detached; each within GRAD_TOL of its leaf's largest value."""
    from unsloth_tpu.ops.moe import moe_mlp_grouped as jmoe
    from unsloth_tpu_torch.ops.moe import moe_mlp as tmoe

    rng = np.random.default_rng(7)
    n, d, f, e, k = 24, 64, 32, 4, 2
    arrs = {
        "x": rng.standard_normal((n, d)), "router": rng.standard_normal((e, d)),
        "router_bias": rng.standard_normal((e,)),
        "gate": rng.standard_normal((e, f, d)) * 0.1,
        "up": rng.standard_normal((e, f, d)) * 0.1,
        "down": rng.standard_normal((e, d, f)) * 0.1,
        "gate_bias": rng.standard_normal((e, f)) * 0.1,
        "up_bias": rng.standard_normal((e, f)) * 0.1,
        "down_bias": rng.standard_normal((e, d)) * 0.1}
    arrs = {kk: v.astype(np.float32) for kk, v in arrs.items()}
    cot = rng.standard_normal((n, d)).astype(np.float32)
    names = ("gate", "up", "down", "gate_bias", "up_bias", "down_bias")

    def jloss(p):
        logits = p["x"] @ p["router"].T + p["router_bias"]
        out = jmoe(p["x"], logits, {nm: p[nm] for nm in names}, k,
                   "gpt_oss_glu", True, interpret=True)
        return jnp.sum(out * cot)

    want = jax.grad(jloss)({kk: jnp.asarray(v) for kk, v in arrs.items()})
    tp = {kk: _t(v).requires_grad_(True) for kk, v in arrs.items()}
    logits = tp["x"] @ tp["router"].t() + tp["router_bias"]
    out = tmoe(tp["x"], logits, {nm: tp[nm] for nm in names}, k,
               "gpt_oss_glu", True, impl="grouped")
    out.backward(_t(cot))
    for name, t in tp.items():
        w = np.asarray(want[name])
        err = np.abs(t.grad.numpy() - w).max() / np.abs(w).max()
        assert err < GRAD_TOL, (name, err)


# ---------------------------------------------------------------------------
# the decoder's full-FT loss
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_ckpts(tmp_path_factory):
    """Tiny llama checkpoints: untied and tied."""
    out = {}
    for tied in (False, True):
        path = str(tmp_path_factory.mktemp(f"llama_tied{int(tied)}"))
        make_hf_checkpoint(path, dict(TINY_LLAMA, tie_word_embeddings=tied))
        out[tied] = path
    return out


@pytest.fixture(scope="module")
def gpt_oss_ckpt(tmp_path_factory):
    """A tiny HF gpt-oss checkpoint (written by transformers) with its
    biases and sinks drawn away from their zero init."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.GptOssForCausalLM(transformers.GptOssConfig(
        vocab_size=96, hidden_size=64, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, num_local_experts=4, num_experts_per_tok=2,
        sliding_window=8, max_position_embeddings=1024,
        tie_word_embeddings=False, pad_token_id=0))
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "bias" in name or "sinks" in name:
                p.normal_(0.0, 0.5)
    path = str(tmp_path_factory.mktemp("gptoss"))
    hf.save_pretrained(path, safe_serialization=True)
    return path


def _load_pair(path):
    os.environ["UNSLOTH_VALIDATE_CHECKPOINT"] = "0"
    tm, _ = FastLanguageModel.from_pretrained(path, dtype="float32",
                                              full_finetuning=True,
                                              device="cpu")
    jm, _ = JFast.from_pretrained(path, dtype="float32",
                                  full_finetuning=True)
    return tm, jm


@pytest.mark.parametrize("remat", [True, "offload", False])
def test_full_ft_loss_and_grads_match_jax(llama_ckpts, remat):
    """loss_fn(params, None, lm_head_trainable=True) on the tied llama (the
    embedding takes gradient from the lookup and from the logits) with
    every leaf requiring grad, under each remat: the loss within 1e-5 and
    every leaf's gradient within GRAD_TOL of jax.grad's."""
    tm, jm = _load_pair(llama_ckpts[True])
    assert "lm_head" not in tm.params
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 120, (2, 32)).astype(np.int32)
    labels = ids.copy()
    labels[1, 20:] = -100
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jdec.loss_fn(p, None, {"input_ids": jnp.asarray(ids),
                                         "labels": jnp.asarray(labels)},
                               jm.cfg, lm_head_trainable=True,
                               remat=False)))(jm.params)
    leaves = tckpt.named_leaves(tm.params)
    for _, t in leaves:
        t.requires_grad_(True)
    loss = tdec.loss_fn(tm.params, None, {"input_ids": _t(ids).long(),
                                          "labels": _t(labels).long()},
                        tm.cfg, lm_head_trainable=True, remat=remat)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    wl = _jax_leaves(jax.tree_util.tree_map(np.asarray, want))
    assert {n for n, _ in leaves} == set(wl)
    for name, t in leaves:
        err = np.abs(t.grad.numpy() - wl[name]).max() / np.abs(
            wl[name]).max()
        assert err < GRAD_TOL, (name, err)


def test_full_ft_over_quantized_base_raises(llama_ckpts):
    """Neither package differentiates an NF4 or FP8 weight: the trainer
    (and check_full_finetune) raise naming the base type."""
    from unsloth_tpu_torch.ops.fp8 import quantize_fp8_block

    tm, _ = FastLanguageModel.from_pretrained(llama_ckpts[False],
                                              dtype="float32",
                                              load_in_4bit=True, device="cpu")
    tr = tsft.SFTTrainer(tm, train_dataset=_docs(4, 128, 0),
                         args=tsft.SFTConfig(max_seq_length=64,
                                             packing=False))
    with pytest.raises(NotImplementedError, match="NF4 base"):
        tr.train()
    tm, _ = FastLanguageModel.from_pretrained(llama_ckpts[False],
                                              dtype="bfloat16",
                                              full_finetuning=True,
                                              device="cpu")
    tm.params["layers"][1]["down"] = quantize_fp8_block(
        tm.params["layers"][1]["down"], 32)
    with pytest.raises(NotImplementedError, match="FP8 base.*layers.1.down"):
        tdec.check_full_finetune(tm.params)


# ---------------------------------------------------------------------------
# SFTTrainer with no LoRA tree
# ---------------------------------------------------------------------------

SFT_KW = dict(per_device_train_batch_size=2, max_seq_length=64,
              warmup_steps=0, learning_rate=1e-3, logging_steps=1,
              packing=False, lr_scheduler_type="constant")


def _train_pair(path, vocab, steps, tmp_path, **kw):
    tm, jm = _load_pair(path)
    ds = _docs(8, vocab, 0)
    args = dict(SFT_KW, max_steps=steps, **kw)
    ttr = tsft.SFTTrainer(tm, train_dataset=ds, args=tsft.SFTConfig(
        output_dir=str(tmp_path / "t"), **args))
    ttr.train()
    jtr = jsft.SFTTrainer(jm, train_dataset=ds, args=jsft.SFTConfig(
        output_dir=str(tmp_path / "j"), **args))
    jtr.train()
    return ttr, jtr


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("model", ["llama", "llama_tied", "gpt_oss"])
def test_full_ft_sft_matches_jax(llama_ckpts, gpt_oss_ckpt, tmp_path, model,
                                 steps):
    """SFTTrainer with no LoRA tree (full fine-tuning: every param trained,
    the head too, a tied head through the embedding) against the JAX
    trainer on the same checkpoint and rows: equal per-step losses and
    every param leaf after the steps (STEP_TOL). gpt-oss's experts train
    through the grouped route's tgmm in the port, JAX's dense MoE on its
    CPU; the router, its bias, the sinks and the expert biases train
    too."""
    path, vocab = {"llama": (llama_ckpts[False], 128),
                   "llama_tied": (llama_ckpts[True], 128),
                   "gpt_oss": (gpt_oss_ckpt, 96)}[model]
    ttr, jtr = _train_pair(path, vocab, steps, tmp_path)
    assert [e["step"] for e in ttr.state_log] == list(range(1, steps + 1))
    np.testing.assert_allclose([e["loss"] for e in ttr.state_log],
                               [e["loss"] for e in jtr.state_log], rtol=1e-5)
    assert ttr.model.lora is None
    assert not any(t.requires_grad
                   for _, t in tckpt.named_leaves(ttr.model.params))
    _assert_trees_close(ttr.model.params,
                        jax.tree_util.tree_map(np.asarray, jtr.model.params),
                        **STEP_TOL)
    ev = ttr.evaluate(_docs(3, vocab, 9))
    jev = jtr.evaluate(_docs(3, vocab, 9))
    assert ev["eval_tokens"] == jev["eval_tokens"]
    np.testing.assert_allclose(ev["eval_loss"], jev["eval_loss"], rtol=1e-4)


def test_galore_sft_matches_jax(tmp_path):
    """optim="galore_adamw" in both trainers on a llama whose hidden and
    intermediate widths reach GaLore's min_dim (256), rank 16, the
    projection refreshed every step: losses (1e-5) and every param after
    3 steps (STEP_TOL scaled to the 1e-2 learning rate)."""
    path = str(tmp_path / "ckpt")
    make_hf_checkpoint(path, dict(TINY_LLAMA, hidden_size=256,
                                  intermediate_size=256))
    tm, jm = _load_pair(path)
    ds = _docs(6, 128, 1)
    args = dict(SFT_KW, max_steps=3, optim="galore_adamw", learning_rate=1e-2,
                extra={"galore_rank": 16, "galore_update_proj_gap": 1})
    ttr = tsft.SFTTrainer(tm, train_dataset=ds, args=tsft.SFTConfig(
        output_dir=str(tmp_path / "t"), **args))
    assert isinstance(tsft.build_optimizer(ttr.args, 3, tm.params)[0],
                      tsft.ClippedGaLore)
    ttr.train()
    jtr = jsft.SFTTrainer(jm, train_dataset=ds, args=jsft.SFTConfig(
        output_dir=str(tmp_path / "j"), **args))
    jtr.train()
    np.testing.assert_allclose([e["loss"] for e in ttr.state_log],
                               [e["loss"] for e in jtr.state_log], rtol=1e-5)
    _assert_trees_close(tm.params,
                        jax.tree_util.tree_map(np.asarray, jm.params),
                        atol=2e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# checkpoints and resume (tests/test_checkpoint_resume.py's)
# ---------------------------------------------------------------------------

def _lora_model(path, r=4):
    tm, _ = FastLanguageModel.from_pretrained(path, dtype="float32",
                                              load_in_4bit=False,
                                              device="cpu")
    return FastLanguageModel.get_peft_model(tm, r=r, lora_alpha=8,
                                            random_state=1)


def test_save_restore_roundtrip(llama_ckpts, tmp_path):
    """The LoRA tree and the optimizer state written and read back: equal
    tensors on the template's device, the same structure, the step."""
    model = _lora_model(llama_ckpts[False])
    tx, _ = tsft.build_optimizer(tsft.SFTConfig(), 10, model.lora)
    for p in tx.params:
        p.grad = torch.ones_like(p)
    tx.step()
    ckpt = str(tmp_path / "checkpoint-7")
    tckpt.save_train_state(ckpt, 7, model.lora, tx.state_dict())
    step, lora2, opt2 = tckpt.restore_train_state(ckpt, model.lora,
                                                  tx.state_dict())
    assert step == 7 and opt2["count"] == 1
    np.testing.assert_array_equal(model.lora["layers"][0]["q"].a.numpy(),
                                  lora2["layers"][0]["q"].a.numpy())
    assert lora2["layers"][0]["q"].a is not model.lora["layers"][0]["q"].a
    assert set(opt2["tensors"]) == set(tx.state_dict()["tensors"])
    for name, t in tx.state_dict()["tensors"].items():
        assert torch.equal(opt2["tensors"][name], t)


def test_latest_checkpoint_skips_incomplete(tmp_path):
    os.makedirs(tmp_path / "checkpoint-5" / "state")
    os.makedirs(tmp_path / "checkpoint-9")  # no state dir: incomplete
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith("checkpoint-5")
    assert tckpt.latest_checkpoint("/nonexistent") is None


def test_restore_latest_falls_back_past_corrupt(llama_ckpts, tmp_path):
    """A corrupt newest checkpoint does not stop a resume: restore_latest
    walks back to the newest one that loads."""
    model = _lora_model(llama_ckpts[False])
    tx, _ = tsft.build_optimizer(tsft.SFTConfig(), 10, model.lora)
    good, bad = str(tmp_path / "checkpoint-3"), str(tmp_path / "checkpoint-8")
    tckpt.save_train_state(good, 3, model.lora, tx.state_dict())
    tckpt.save_train_state(bad, 8, model.lora, tx.state_dict())
    for root, _, files in os.walk(os.path.join(bad, "state")):
        for f in files:
            if f.endswith(".safetensors"):
                with open(os.path.join(root, f), "w") as fh:
                    fh.write("corrupt")
    path, step, lora2, _ = tckpt.restore_latest(str(tmp_path), model.lora,
                                                tx.state_dict())
    assert step == 3 and path.endswith("checkpoint-3")
    np.testing.assert_array_equal(model.lora["layers"][0]["q"].a.numpy(),
                                  lora2["layers"][0]["q"].a.numpy())


@pytest.mark.parametrize("full", [False, True])
def test_trainer_resume_continues(llama_ckpts, tmp_path, full):
    """Six steps saving at step 4 (an epoch boundary: 8 rows in batches of
    4), and a fresh trainer resumed from checkpoint-4 for steps 5-6: the
    resume starts at step 5 with the schedule's count (warmup, then linear
    decay) and the epoch's shuffle restored, and its final trainables
    equal the uninterrupted run's bit for bit on the CPU; LoRA (the
    adapter sits beside the state) and full fine-tuning (the tied
    llama)."""
    ds = _docs(8, 128, 0)
    args = dict(per_device_train_batch_size=4, learning_rate=1e-3,
                max_seq_length=48, packing=False, warmup_steps=2,
                lr_scheduler_type="linear", logging_steps=1, seed=11,
                max_steps=6)

    def model():
        if full:
            return FastLanguageModel.from_pretrained(
                llama_ckpts[True], dtype="float32", full_finetuning=True,
                device="cpu")[0]
        return _lora_model(llama_ckpts[False])

    def trainables(m):
        return m.params if full else m.lora

    out = str(tmp_path / "run")
    m_full = model()
    tr1 = tsft.SFTTrainer(m_full, train_dataset=ds, args=tsft.SFTConfig(
        output_dir=out, save_steps=4, **args))
    tr1.train()
    assert tckpt.latest_checkpoint(out).endswith("checkpoint-4")
    assert os.path.exists(os.path.join(
        out, "checkpoint-4", "adapter_model.safetensors")) is not full
    m_res = model()
    tr2 = tsft.SFTTrainer(m_res, train_dataset=ds, args=tsft.SFTConfig(
        output_dir=str(tmp_path / "resumed"), **args))
    tr2.train(resume_from_checkpoint=os.path.join(out, "checkpoint-4"))
    assert [e["step"] for e in tr2.state_log] == [5, 6]
    assert [e["loss"] for e in tr2.state_log] == \
        [e["loss"] for e in tr1.state_log[4:]]
    for (name, a), (_, b) in zip(tckpt.named_leaves(trainables(m_full)),
                                 tckpt.named_leaves(trainables(m_res))):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# modules_to_save and embedding_learning_rate (tests/test_embedding_lr.py's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tied", [False, True])
def test_modules_to_save_creates_trainable_copies(llama_ckpts, tied):
    """fp32 copies of embed and lm_head in the LoRA tree, equal to the
    base and to JAX's; a tied model's lm_head copy comes from embed (which
    unties the head); unknown names are skipped; the names are recorded."""
    os.environ["UNSLOTH_VALIDATE_CHECKPOINT"] = "0"
    tm, _ = FastLanguageModel.from_pretrained(llama_ckpts[tied],
                                              load_in_4bit=False,
                                              dtype="float32", device="cpu")
    jm, _ = JFast.from_pretrained(llama_ckpts[tied], load_in_4bit=False,
                                  dtype="float32")
    mods = ["embed_tokens", "lm_head", "norm"]
    tm = FastLanguageModel.get_peft_model(tm, r=4, modules_to_save=mods)
    jm = JFast.get_peft_model(jm, r=4, modules_to_save=mods)
    assert {"embed", "lm_head"} <= set(tm.lora) and "norm" not in tm.lora
    assert tm.lora_config["modules_to_save"] == mods
    for name in ("embed", "lm_head"):
        assert tm.lora[name].dtype == torch.float32
        np.testing.assert_array_equal(tm.lora[name].numpy(),
                                      np.asarray(jm.lora[name]))
    src = tm.params["embed"] if tied else tm.params["lm_head"]
    np.testing.assert_array_equal(tm.lora["lm_head"].numpy(), src.numpy())
    assert tm.lora["lm_head"].data_ptr() != src.data_ptr()
    assert tdec._head_weight(tm.params, tm.lora)[0] is tm.lora["lm_head"]
    # over a bf16 base the fp32 copy's rows enter the stack in bf16, the
    # dtype the CUDA kernels take
    bm, _ = FastLanguageModel.from_pretrained(llama_ckpts[tied],
                                              load_in_4bit=False,
                                              dtype="bfloat16", device="cpu")
    bm = FastLanguageModel.get_peft_model(bm, r=4, modules_to_save=mods)
    assert bm.lora["embed"].dtype == torch.float32
    h = tdec.forward(bm.params, bm.lora, torch.arange(3, 19)[None], bm.cfg,
                     remat=False)
    assert h.dtype == torch.bfloat16


def test_embeddings_train_and_shadow_base_match_jax(llama_ckpts, tmp_path):
    """get_peft_model(modules_to_save=["embed_tokens", "lm_head"]) and
    embedding_learning_rate in both packages, 3 steps: equal losses; the
    trainable copies and every adapter equal to JAX's (STEP_TOL); the
    frozen base untouched; the adapter file carries no copy (JAX's
    save_lora writes adapters only)."""
    tm = _lora_model(llama_ckpts[False])
    tm = FastLanguageModel.get_peft_model(
        tm, r=4, lora_alpha=8, random_state=1,
        modules_to_save=["embed_tokens", "lm_head"])
    jm, _ = JFast.from_pretrained(llama_ckpts[False], load_in_4bit=False,
                                  dtype="float32")
    jm = JFast.get_peft_model(jm, r=4, lora_alpha=8,
                              modules_to_save=["embed_tokens", "lm_head"])
    # the same adapters in both: the port's init carried to JAX
    from unsloth_tpu.ops.lora import LoRAWeights as JLoRA
    for jl, tl in zip(jm.lora["layers"], tm.lora["layers"]):
        for name in jl:
            jl[name] = JLoRA(a=jnp.asarray(tl[name].a.numpy().copy()),
                             b=jnp.asarray(tl[name].b.numpy().copy()),
                             scale=tl[name].scale)
    base = tm.params["embed"].clone()
    ds = _docs(8, 128, 2)
    args = dict(SFT_KW, per_device_train_batch_size=4, max_steps=3,
                learning_rate=1e-2, embedding_learning_rate=1e-3)
    ttr = tsft.SFTTrainer(tm, train_dataset=ds, args=tsft.SFTConfig(
        output_dir=str(tmp_path / "t"), **args))
    tx, _ = tsft.build_optimizer(ttr.args, 3, tm.lora)
    assert sorted(set(tx.lr_scales)) == [0.1, 1.0]
    ttr.train()
    jtr = jsft.SFTTrainer(jm, train_dataset=ds, args=jsft.SFTConfig(
        output_dir=str(tmp_path / "j"), **args))
    jtr.train()
    np.testing.assert_allclose([e["loss"] for e in ttr.state_log],
                               [e["loss"] for e in jtr.state_log], rtol=1e-5)
    _assert_trees_close(tm.lora, jax.tree_util.tree_map(np.asarray, jm.lora),
                        atol=2e-3, rtol=1e-3)
    assert not torch.equal(tm.lora["embed"], base)
    assert torch.equal(tm.params["embed"], base)
    tm.save_lora(str(tmp_path / "adapter"))
    names = set(SafetensorsFile(str(tmp_path / "adapter" /
                                    "adapter_model.safetensors")).keys())
    assert names and not any("embed" in n or "lm_head" in n for n in names)


def test_embedding_lr_is_smaller(llama_ckpts, tmp_path):
    """With embedding_learning_rate << learning_rate the embedding copy
    moves much less than at the full rate."""
    def run(embed_lr):
        m = FastLanguageModel.get_peft_model(
            _lora_model(llama_ckpts[False]), r=4,
            modules_to_save=["embed_tokens"])
        before = m.lora["embed"].clone()
        tsft.SFTTrainer(m, train_dataset=_docs(8, 128, 0),
                        args=tsft.SFTConfig(
                            output_dir=str(tmp_path), max_steps=3,
                            embedding_learning_rate=embed_lr,
                            **dict(SFT_KW, per_device_train_batch_size=4,
                                   learning_rate=1e-2))).train()
        return float((m.lora["embed"] - before).abs().max())

    big, small = run(1e-2), run(1e-4)
    assert small < big * 0.2, (small, big)


# ---------------------------------------------------------------------------
# GaLore / Q-GaLore (tests/test_optimizer_galore.py's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,tol", [("galore", 2e-3), ("q_galore", 3e-2)])
def test_galore_updates_match_jax(name, tol):
    """Five updates of the port's transform and JAX's on the same random
    gradients (two matrices projected on either side, a vector and a
    small matrix on plain Adam), the projection refreshed at updates 1 and
    4 and a schedule on the count: every update within ``tol`` of its
    leaf's largest |update|. GaLore: the SVDs differ in their last fp32
    bits (and maybe in sign, which the update cancels); Q-GaLore: those
    bits can move an int8 code of the projector or the moments by one
    step, 1/127 of its block's largest value."""
    shapes = [(40, 70), (90, 50), (16,), (8, 8)]
    kw = dict(learning_rate=lambda c: 1e-2 * c, rank=8, update_proj_gap=3,
              min_dim=32)
    jtx, ttx = getattr(jgalore, name)(**kw), getattr(tgalore, name)(**kw)
    js = jtx.init([jnp.zeros(s) for s in shapes])
    jupdate = jax.jit(jtx.update)
    ts = ttx.init([torch.zeros(s) for s in shapes])
    rng = np.random.default_rng(5)
    for _ in range(5):
        gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        ju, js = jupdate([jnp.asarray(g) for g in gs], js)
        tu, ts = ttx.update([_t(g) for g in gs], ts)
        for a, b in zip(ju, tu):
            a = np.asarray(a)
            assert np.abs(a - b.numpy()).max() <= tol * np.abs(a).max()
    assert ts.count == 5
    if name == "q_galore":
        assert ts.inner[0][0].dtype == torch.int8
        assert ts.inner[0][2].dtype == torch.int8


def test_state_memory_compression():
    params = [torch.zeros((1024, 1024)), torch.zeros((1024,))]
    ratio = tgalore.state_memory_ratio(params, rank=64)
    assert ratio < 0.3  # Adam would be 2.0
    assert ratio == jgalore.state_memory_ratio(
        {"w": jnp.zeros((1024, 1024)), "b": jnp.zeros((1024,))}, rank=64)
    qs = tgalore.q_galore(rank=16).init([torch.zeros((512, 512))])
    assert tgalore.state_bytes(qs) < 2 * 512 * 512 * 4 / 8


def test_small_params_use_plain_adam():
    tx = tgalore.galore(learning_rate=1e-2, rank=32, min_dim=256)
    params = [torch.ones((8, 8)), torch.ones((16,))]
    state = tx.init(params)
    updates, state = tx.update([torch.ones((8, 8)), torch.ones((16,))],
                               state)
    assert state.inner[0][0] is None
    np.testing.assert_allclose(updates[1].numpy(), -1e-2, rtol=0.2)


def test_full_finetune_tiny_model_with_galore():
    """Full fine-tuning of a tiny model's loss through the clipped GaLore
    optimizer, 25 steps: the loss falls by more than 0.5."""
    from unsloth_tpu_torch.models.config import ModelConfig
    from unsloth_tpu_torch.models.params import init_params

    cfg = ModelConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=2, num_kv_heads=2)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (2, 32)))
    batch = {"input_ids": ids, "labels": ids}
    leaves = [t for _, t in tckpt.named_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    opt = tsft.ClippedGaLore(leaves, tgalore.galore(
        learning_rate=1e-2, rank=16, update_proj_gap=5, min_dim=64),
        max_grad_norm=1.0)
    losses = []
    for _ in range(25):
        loss = tdec.loss_fn(params, None, batch, cfg, lm_head_trainable=True,
                            remat=False)
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# the loader (C8, C9), the saves, interop
# ---------------------------------------------------------------------------

def test_notebook_keywords_load_in_both_packages(llama_ckpts):
    """C8: the GRPO notebook's from_pretrained keywords and the Alpaca
    notebook's get_peft_model keywords run in both packages (the unused
    ones ignored); qat_scheme without full fine-tuning is a ValueError in
    both."""
    os.environ["UNSLOTH_VALIDATE_CHECKPOINT"] = "0"
    path = llama_ckpts[False]
    load_kw = dict(max_seq_length=64, load_in_4bit=False, fast_inference=True,
                   max_lora_rank=32, gpu_memory_utilization=0.6, token=None)
    peft_kw = dict(r=4, lora_alpha=8, lora_dropout=0.0, bias="none",
                   use_gradient_checkpointing="unsloth", random_state=3407,
                   use_rslora=False, loftq_config=None, max_seq_length=2048)
    tm, _ = FastLanguageModel.from_pretrained(path, dtype="float32",
                                              device="cpu", **load_kw)
    jm, _ = JFast.from_pretrained(path, dtype="float32", **load_kw)
    tm = FastLanguageModel.get_peft_model(tm, **peft_kw)
    jm = JFast.get_peft_model(jm, **peft_kw)
    assert set(tm.lora["layers"][0]) == set(jm.lora["layers"][0])
    assert tm.gc_mode == jm.gc_mode == "offload"
    for fast in (FastLanguageModel, JFast):
        with pytest.raises(ValueError, match="full_finetuning=True"):
            fast.from_pretrained(path, qat_scheme="int4")


def test_hub_name_resolves_through_the_cache(llama_ckpts, tmp_path,
                                             monkeypatch):
    """C9: a checkpoint in a temporary HF_HOME cache layout, loaded by the
    notebook's name unsloth/Meta-Llama-3.1-8B-bnb-4bit in both packages:
    the mapper sends it to meta-llama/Meta-Llama-3.1-8B with load_in_4bit
    True, both resolve the same snapshot, and the NF4 params are equal
    byte for byte."""
    from unsloth_tpu.models.mapper import get_model_name as jname
    from unsloth_tpu_torch.models.mapper import get_model_name, search_models

    name = "unsloth/Meta-Llama-3.1-8B-bnb-4bit"
    assert get_model_name(name, False) == jname(name, False) == (
        "meta-llama/Meta-Llama-3.1-8B", True)
    assert "meta-llama/Meta-Llama-3.1-8B" in search_models("llama-3.1-8b")
    snap = tmp_path / "hub" / "models--meta-llama--Meta-Llama-3.1-8B" / \
        "snapshots" / "0123abc"
    make_hf_checkpoint(str(snap), TINY_LLAMA)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.setenv("UNSLOTH_VALIDATE_CHECKPOINT", "0")
    tm, _ = FastLanguageModel.from_pretrained(name, dtype="float32",
                                              device="cpu")
    jm, _ = JFast.from_pretrained(name, dtype="float32")
    assert tm.model_path == jm.model_path == str(snap)
    got = tm.params["layers"][0]["q"]
    want = jm.params["layers"][0]["q"]
    assert type(got).__name__ == "NF4Tensor"
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.absmax.numpy(), np.asarray(want.absmax))
    with pytest.raises(FileNotFoundError, match="HF cache"):
        FastLanguageModel.from_pretrained("nobody/none", device="cpu")


def test_merged_save_after_full_ft_matches_jax(llama_ckpts, tmp_path):
    """After one full-FT step, save_pretrained_merged writes the trained
    params: the file JAX writes for the same params, tensor for tensor;
    reloaded, its logits equal the trained model's (bf16 file: 2e-2 of
    the largest logit). save_lora with no LoRA tree writes an empty
    adapter, as JAX's does."""
    from unsloth_tpu.export import save as jsave
    from unsloth_tpu.models.loader import LanguageModel as JModel

    tm, jm = _load_pair(llama_ckpts[False])
    tsft.SFTTrainer(tm, train_dataset=_docs(4, 128, 0), args=tsft.SFTConfig(
        output_dir=str(tmp_path / "o"), max_steps=1, **SFT_KW)).train()
    tm.save_pretrained_merged(str(tmp_path / "t"))
    jtree = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tm.params))
    jsave.save_pretrained_merged(
        JModel(cfg=jm.cfg, params=jtree, model_path=jm.model_path,
               hf_config=jm.hf_config), str(tmp_path / "j"))
    got = SafetensorsFile(str(tmp_path / "t" / "model.safetensors"))
    want = SafetensorsFile(str(tmp_path / "j" / "model.safetensors"))
    assert set(got.keys()) == set(want.keys())
    for name in got.keys():
        assert torch.equal(got.get(name), want.get(name)), name
    back, _ = FastLanguageModel.from_pretrained(str(tmp_path / "t"),
                                                dtype="float32",
                                                full_finetuning=True,
                                                device="cpu")
    ids = torch.arange(3, 35).reshape(1, 32)
    with torch.no_grad():
        a = tdec.logits_fn(tm.params, None, ids, tm.cfg, remat=False)
        b = tdec.logits_fn(back.params, None, ids, back.cfg, remat=False)
    assert (a - b).abs().max() <= 2e-2 * a.abs().max()
    for model, save in ((tm, None), (jm, jsave.save_lora)):
        out = str(tmp_path / ("lt" if save is None else "lj"))
        model.save_lora(out) if save is None else save(model, out)
        with open(os.path.join(out, "adapter_config.json")) as f:
            assert json.load(f)["target_modules"] == []
        assert not list(SafetensorsFile(os.path.join(
            out, "adapter_model.safetensors")).keys())


def test_params_to_numpy_round_trip(llama_ckpts):
    tm, _ = FastLanguageModel.from_pretrained(llama_ckpts[True],
                                              dtype="bfloat16",
                                              full_finetuning=True,
                                              device="cpu")
    back = params_from_numpy(params_to_numpy(tm.params), "cpu",
                             torch.bfloat16)
    for (n, a), (_, b) in zip(tckpt.named_leaves(tm.params),
                              tckpt.named_leaves(back)):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# C7: chip_smoke's GRPO phase leaves no reference cycle
# ---------------------------------------------------------------------------

def test_patched_methods_leave_no_cycle(llama_ckpts, tmp_path):
    """chip_smoke.patched_methods, as phase_grpo patches a GRPOTrainer and
    its logger: with the collector off, the trainer and its model are
    freed at ``del`` once the block is left. Restoring by assignment (the
    earlier code) keeps both alive."""
    import torch._dynamo  # noqa: F401  (its first import holds frames)

    from chip_smoke import patched_methods
    from unsloth_tpu_torch import GRPOConfig, GRPOTrainer

    def trainer():
        m = FastLanguageModel.get_peft_model(_lora_model(llama_ckpts[False]),
                                             r=4)
        return GRPOTrainer(m, reward_funcs=[], train_dataset=[],
                           args=GRPOConfig(output_dir=str(tmp_path)))

    gc.collect()
    gc.disable()
    try:
        tr = trainer()
        gen, logps, loss, log = (tr._generate_batch, tr._logps, tr._loss,
                                 tr.metrics_logger.log)
        with patched_methods(tr, _generate_batch=lambda p: gen(p),
                             _logps=lambda *a: logps(*a),
                             _loss=lambda *a: loss(*a)), \
                patched_methods(tr.metrics_logger, log=lambda e: log(e)):
            assert "_loss" in vars(tr)
        assert "_loss" not in vars(tr) and "log" not in vars(
            tr.metrics_logger)
        del gen, logps, loss, log
        alive = weakref.ref(tr), weakref.ref(tr.model)
        del tr
        assert alive[0]() is None and alive[1]() is None

        tr = trainer()
        tr._loss, tr.metrics_logger.log = tr._loss, tr.metrics_logger.log
        alive = weakref.ref(tr), weakref.ref(tr.model)
        del tr
        assert alive[0]() is not None and alive[1]() is not None
    finally:
        gc.enable()
        gc.collect()
