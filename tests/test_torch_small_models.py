"""The small Llama-family models in the PyTorch port against the JAX
package, on the CPU in f32: tiny checkpoints of the shapes of
Llama-3.2-1B (head dim 64, tied embedding, llama3 rope; NF4 on load, and
once more from a bnb-4bit checkpoint as phase 10 of chip_smoke.py loads
it), Qwen2.5-0.5B (q/k/v biases, tied, 7 query heads a kv head, head dim
64; a dense base, as phase 11 trains it) and Gemma-1 (head dim 256, no
softcap; NF4), each loaded by both packages from the same directory:
the param trees, logits, a padded batch's loss and every LoRA gradient,
and padded SFTTrainer with train_on_responses_only (per-step losses,
adapters, evaluate)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.helpers import make_hf_checkpoint
from tests.test_torch_unpacked import (INSTR, RESP, T, ByteTokenizer,
                                       _alpaca_texts, _nonzero_lora)
from unsloth_tpu.models import decoder as jdec
from unsloth_tpu.models import hf_loader as jloader
from unsloth_tpu.models.config import ModelConfig as JConfig
from unsloth_tpu.models.loader import LanguageModel as JModel
from unsloth_tpu.trainer import sft as jsft
from unsloth_tpu_torch import FastLanguageModel
from unsloth_tpu_torch.data.packing import pad_batch
from unsloth_tpu_torch.interop import (lora_from_numpy, lora_to_numpy,
                                       params_from_numpy)
from unsloth_tpu_torch.models import decoder as tdec
from unsloth_tpu_torch.models.loader import LanguageModel as TModel
from unsloth_tpu_torch.ops.nf4 import NF4Tensor
from unsloth_tpu_torch.trainer import sft as tsft

TINY = dict(num_hidden_layers=2, vocab_size=300, max_position_embeddings=512)
#: id -> (HF config, load_in_4bit, bnb-4bit checkpoint)
MODELS = {
    "llama32": (dict(chip_smoke.LLAMA_32_1B_CONFIG, **TINY, hidden_size=256,
                     intermediate_size=512, num_attention_heads=4,
                     num_key_value_heads=2,
                     rope_scaling=dict(chip_smoke.LLAMA_32_1B_CONFIG[
                         "rope_scaling"], original_max_position_embeddings=64)),
                True, False),
    "llama32-bnb": (None, True, True),
    "qwen2": (dict(chip_smoke.QWEN25_05B_CONFIG, **TINY, hidden_size=448,
                   intermediate_size=512, num_attention_heads=7,
                   num_key_value_heads=1, sliding_window=512), False, False),
    "gemma": (dict(chip_smoke.GEMMA_7B_CONFIG, **TINY, hidden_size=256,
                   intermediate_size=512, num_attention_heads=2,
                   num_key_value_heads=2), True, False),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _write(path, name):
    """The tiny checkpoint of model ``name``: tests/helpers.py's writer (f32
    weights; for Qwen2 with its q/k/v biases, and no attention_bias key in
    config.json, as Qwen2.5 publishes it), or chip_smoke.py's bnb-4bit
    writer for the bnb variant."""
    hf, _, bnb = MODELS[name]
    if bnb:
        hf = MODELS["llama32"][0]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(chip_smoke, "DEVICE", "cpu")
            chip_smoke.write_checkpoint(path, hf, bnb4=True)
        return hf
    make_hf_checkpoint(path, dict(hf, attention_bias=hf["model_type"]
                                  == "qwen2"))
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(hf, fh)
    return hf


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request, tmp_path_factory):
    """(name, JAX cfg, JAX params, port model, port-loaded params, LoRA
    numpy tree) from one checkpoint directory, loaded by each package's
    own loader. Where both quantize on load, the port model holds the JAX
    package's NF4 tree carried byte for byte (interop), as the other
    parity tests do: the two quantizers' fp32 means of the block scales
    may differ in the last bits (another sum order), and a double-quant
    code with them (test_params_match_jax holds them to that)."""
    name = request.param
    path = str(tmp_path_factory.mktemp(name))
    hf = _write(path, name)
    load4 = MODELS[name][1]
    jcfg = JConfig.from_hf_config(hf)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNSLOTH_VALIDATE_CHECKPOINT", "0")
        jparams = jloader.load_params(path, jcfg, dtype=jnp.float32,
                                      load_in_4bit=load4)
    model, _ = FastLanguageModel.from_pretrained(
        path, load_in_4bit=load4, dtype=torch.float32, device="cpu")
    loaded = model.params
    if load4 and not MODELS[name][2]:
        model.params = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    lora_np = jax.tree_util.tree_map(np.asarray, _nonzero_lora(jcfg))
    return name, jcfg, jparams, model, loaded, lora_np


def test_params_match_jax(pair):
    """The port's loader gives JAX's tree: no lm_head (tied), Qwen2's q/k/v
    biases and no o bias, the head dims of the published models, and the
    projections NF4 with equal bytes (absmax codes at most one apart,
    where the two fp32 means of the scales differ in the last bits; bnb's
    decoded absmax equal), or, on a dense base, the same f32 weights."""
    name, jcfg, jparams, _, loaded, _ = pair
    jtree = jax.tree_util.tree_map(np.asarray, jparams)
    assert set(loaded) == set(jtree) == {"embed", "final_norm", "layers"}
    np.testing.assert_array_equal(loaded["embed"].numpy(), jtree["embed"])
    for tl, jl in zip(loaded["layers"], jtree["layers"]):
        assert set(tl) == set(jl)
        assert tuple(tl["q"].shape) == (jcfg.num_heads * (
            256 if name == "gemma" else 64), jcfg.hidden_size)
        if name == "qwen2":
            assert {"q_bias", "k_bias", "v_bias"} <= set(tl)
            assert "o_bias" not in tl
            np.testing.assert_array_equal(tl["k_bias"].numpy(), jl["k_bias"])
        for proj in ("q", "k", "v", "o", "gate", "up", "down"):
            t, j = tl[proj], jl[proj]
            if not MODELS[name][1]:
                np.testing.assert_array_equal(t.numpy(), j)
                continue
            assert isinstance(t, NF4Tensor)
            np.testing.assert_array_equal(t.packed.numpy(), j.packed)
            if MODELS[name][2]:
                np.testing.assert_array_equal(t.absmax.numpy(), j.absmax)
                continue
            codes = np.abs(t.absmax.numpy().astype(int)
                           - j.absmax.astype(int))
            assert codes.max() <= 1 and (codes != 0).mean() < 1e-2
            np.testing.assert_allclose(float(t.absmax_offset),
                                       float(j.absmax_offset), rtol=1e-6)


def test_logits_match_jax(pair):
    """Logits of two rows, f32: 1e-5 relative plus 1e-4."""
    _, jcfg, jparams, model, _, lora_np = pair
    ids = np.random.default_rng(2).integers(0, 300, (2, 40))
    want = np.asarray(jdec.logits_fn(jparams, jax.tree_util.tree_map(
        jnp.asarray, lora_np), jnp.asarray(ids), jcfg))
    got = tdec.logits_fn(model.params, lora_from_numpy(lora_np, "cpu"),
                         _t(ids), model.cfg, remat=False)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-4)


def _padded_batch():
    rng = np.random.default_rng(3)
    rows = [{"input_ids": rng.integers(0, 300, n).tolist()}
            for n in (90, T)]
    return pad_batch(rows, T).as_dict()


def test_loss_and_lora_grads_match_jax(pair):
    """loss_fn on a padded batch (a row of 90 real tokens and a pad tail,
    a full row) and d loss / d every LoRA leaf, f32: loss within 1e-5
    relative, each gradient leaf within 1e-4 of its largest value."""
    _, jcfg, jparams, model, _, lora_np = pair
    batch = _padded_batch()
    jl, jg = jax.value_and_grad(lambda lo: jdec.loss_fn(
        jparams, lo, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
        remat=False))(jax.tree_util.tree_map(jnp.asarray, lora_np))
    tlora = lora_from_numpy(lora_np, "cpu")
    for layer in tlora["layers"]:
        for lw in layer.values():
            lw.a.requires_grad_(True)
            lw.b.requires_grad_(True)
    tl = tdec.loss_fn(model.params, tlora,
                      {k: _t(v) for k, v in batch.items()}, model.cfg,
                      remat=False)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for jlayer, tlayer in zip(jg["layers"], tlora["layers"]):
        assert set(jlayer) == set(tlayer)
        for proj, jw in jlayer.items():
            for part in ("a", "b"):
                want = np.asarray(getattr(jw, part))
                got = getattr(tlayer[proj], part).grad.numpy()
                err = np.abs(got - want).max() / np.abs(want).max()
                assert err < 1e-4, (proj, part, err)


@pytest.fixture(scope="module")
def trainers(pair, tmp_path_factory):
    """Four steps of padded SFT (batch 2, accumulation 2) with
    train_on_responses_only from the loaded weights and the same nonzero
    LoRA in both packages, then evaluate on five held-out texts."""
    name, jcfg, jparams, model, _, lora_np = pair
    tmp = tmp_path_factory.mktemp("sft-" + name)
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
    tmodel = TModel(cfg=model.cfg, params=model.params, max_seq_length=T,
                    lora=lora_from_numpy(lora_np, "cpu"), gc_mode="offload")
    ttr = tsft.SFTTrainer(tmodel, tokenizer=tok, train_dataset=data,
                          args=tsft.SFTConfig(output_dir=str(tmp / "t"), **kw))
    tsft.train_on_responses_only(ttr, instruction_part=INSTR,
                                 response_part=RESP)
    tsft.unsloth_train(ttr)
    teval = ttr.evaluate(held_out)
    return jtr, ttr, jeval, teval


def test_padded_sft_matches_jax(trainers):
    """Identical padded batches; per-step losses within 1e-4 relative (f32
    through AdamW updates); the trained adapters within 1e-3 relative L2;
    eval_loss within 1e-4 relative over the same eval_tokens."""
    jtr, ttr, jeval, teval = trainers
    for jb, tb in zip(jtr._batches, ttr._batches):
        for key, a in jb.as_dict().items():
            np.testing.assert_array_equal(tb.as_dict()[key], np.asarray(a))
    assert len(ttr.state_log) == len(jtr.state_log) == 4
    for je, te in zip(jtr.state_log, ttr.state_log):
        np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-4)
    trained = lora_to_numpy(ttr.model.lora)
    for jlayer, tlayer in zip(jtr.model.lora["layers"], trained["layers"]):
        for proj, jw in jlayer.items():
            for part in ("a", "b"):
                want = np.asarray(getattr(jw, part))
                got = getattr(tlayer[proj], part)
                assert np.linalg.norm(got - want) / np.linalg.norm(want) \
                    < 1e-3, (proj, part)
    assert teval["eval_tokens"] == jeval["eval_tokens"] > 0
    np.testing.assert_allclose(teval["eval_loss"], jeval["eval_loss"],
                               rtol=1e-4)
