"""The training slice of the PyTorch port against the JAX package, on the
CPU in f32: a 2-layer NF4 + LoRA llama's packed-batch loss and every LoRA
gradient (every remat mode, both CE routes), the LR schedules against
optax, the clipped AdamW against optax, and SFTTrainer's per-step losses
against the JAX SFTTrainer on the same data and the same LoRA init."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unsloth_tpu.data.packing import batch_packed_rows, pack_sequences
from unsloth_tpu.models import decoder as jdec
from unsloth_tpu.models.config import ModelConfig as JConfig
from unsloth_tpu.models.config import RopeScaling as JRope
from unsloth_tpu.models.loader import LanguageModel as JModel
from unsloth_tpu.models.params import (init_lora_tree, init_params,
                                       quantize_params)
from unsloth_tpu.ops.lora import LoRAWeights
from unsloth_tpu.trainer import sft as jsft
from unsloth_tpu_torch.interop import (lora_from_numpy, lora_to_numpy,
                                       params_from_numpy)
from unsloth_tpu_torch.models import decoder as tdec
from unsloth_tpu_torch.models.config import ModelConfig as TConfig
from unsloth_tpu_torch.models.config import RopeScaling as TRope
from unsloth_tpu_torch.models.loader import LanguageModel as TModel
from unsloth_tpu_torch.ops.attention import packed_segment_bound
from unsloth_tpu_torch.trainer import sft as tsft

BASE = dict(model_type="llama", vocab_size=256, hidden_size=128,
            intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
            max_position_embeddings=512, rms_norm_eps=1e-5,
            rope_theta=10000.0)
LLAMA3 = dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
              high_freq_factor=4.0, original_max_position_embeddings=64)
T = 128


def _configs():
    return (JConfig(**BASE, rope_scaling=JRope(**LLAMA3)),
            TConfig(**BASE, rope_scaling=TRope(**LLAMA3)))


def _nonzero_lora(cfg, seed=7):
    """init_lora_tree zeroes B; give it values so every LoRA grad is live."""
    tree = init_lora_tree(cfg, jax.random.PRNGKey(1), r=4, alpha=8.0)
    rng = np.random.default_rng(seed)
    for layer in tree["layers"]:
        for name, lw in list(layer.items()):
            b = rng.standard_normal(lw.b.shape).astype(np.float32) * 0.05
            layer[name] = LoRAWeights(lw.a, jnp.asarray(b), lw.scale)
    return tree


@pytest.fixture(scope="module")
def model_pair():
    """(jax cfg, params, lora), (torch cfg, params): NF4 base weights
    quantized by JAX and carried byte for byte."""
    jcfg, tcfg = _configs()
    jparams = quantize_params(init_params(jcfg, jax.random.PRNGKey(0)), jcfg,
                              dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return (jcfg, jparams, _nonzero_lora(jcfg)), (tcfg, tparams)


def _docs(n, lo, hi, seed):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(3, 200, rng.randint(lo, hi)).tolist()}
            for _ in range(n)]


def _packed_batch():
    """Two packed rows of T tokens with segment ids, positions and boundary-
    masked labels (the second row ends in a pad tail)."""
    rows = pack_sequences(_docs(9, 10, 60, seed=0), T)
    return batch_packed_rows(rows, 2, T)[0].as_dict()


def _torch_lora(jlora):
    tl = lora_from_numpy(jax.tree_util.tree_map(np.asarray, jlora), "cpu")
    for layer in tl["layers"]:
        for lw in layer.values():
            lw.a.requires_grad_(True)
            lw.b.requires_grad_(True)
    return tl


@pytest.fixture(scope="module")
def jax_loss_and_grads(model_pair):
    """JAX loss_fn value and LoRA grads on the packed batch, per CE route
    (remat changes no value, so JAX runs without it, jitted)."""
    (jcfg, jparams, jlora), _ = model_pair
    batch = _packed_batch()
    n_items = float((batch["labels"][:, 1:] != -100).sum() + 7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for fused_ce in (False, True):
        fn = jax.jit(jax.value_and_grad(
            lambda lo, p, b, fc=fused_ce: jdec.loss_fn(
                p, lo, b, jcfg, n_items=jnp.float32(n_items), fused_ce=fc,
                chunk_size=96, remat=False)))
        out[fused_ce] = fn(jlora, jparams, jbatch)
    return batch, n_items, out


@pytest.mark.parametrize("remat,fused_ce", [
    (False, False), (True, True), ("offload", False)])
def test_loss_and_lora_grads_match_jax(model_pair, jax_loss_and_grads, remat,
                                       fused_ce):
    """loss_fn on a packed batch under a declared segment bound, and d loss
    / d every LoRA leaf, with n_items given. f32: loss within 1e-5
    relative, each gradient leaf within 1e-4 of its largest value (fp32
    sums in other orders through two layers)."""
    (_, _, jlora), (tcfg, tparams) = model_pair
    batch, n_items, jax_out = jax_loss_and_grads
    jl, jg = jax_out[fused_ce]
    tlora = _torch_lora(jlora)
    with packed_segment_bound(60):
        tl = tdec.loss_fn(tparams, tlora,
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          tcfg, n_items=torch.tensor(n_items),
                          fused_ce=fused_ce, chunk_size=96, remat=remat)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for jlayer, tlayer in zip(jg["layers"], tlora["layers"]):
        for name, jw in jlayer.items():
            for part in ("a", "b"):
                want = np.asarray(getattr(jw, part))
                got = getattr(tlayer[name], part).grad.numpy()
                err = np.abs(got - want).max() / np.abs(want).max()
                assert err < 1e-4, (name, part, err)


def test_logits_fn_matches_jax(model_pair):
    (jcfg, jparams, jlora), (tcfg, tparams) = model_pair
    ids = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(np.int32)
    want = jdec.logits_fn(jparams, jlora, jnp.asarray(ids), jcfg, remat=False)
    got = tdec.logits_fn(tparams, _torch_lora(jlora), torch.from_numpy(ids),
                         tcfg, remat=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(lr_scheduler_type="linear", warmup_steps=3),
    dict(lr_scheduler_type="cosine", warmup_steps=0, warmup_ratio=0.25),
    dict(lr_scheduler_type="constant", warmup_steps=2),
    dict(lr_scheduler_type="linear", warmup_steps=0)])
def test_schedule_matches_optax(kw):
    total = 12
    want = jsft.build_schedule(jsft.SFTConfig(learning_rate=3e-4, **kw), total)
    got = tsft.build_schedule(tsft.SFTConfig(learning_rate=3e-4, **kw), total)
    for step in range(total + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("max_grad_norm", [1.0, 100.0])
def test_clipped_adamw_matches_optax(max_grad_norm):
    """Four updates of optax.chain(clip_by_global_norm, adamw(schedule))
    and of ClippedAdamW from the same params and grads, with warmup (the
    first LR is 0) and with/without the clip firing; f32, 1e-6."""
    rng = np.random.default_rng(0)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in ((4, 8), (8,), (3, 3))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in params]
             for _ in range(4)]
    args = dict(learning_rate=1e-2, warmup_steps=2, weight_decay=0.1,
                max_grad_norm=max_grad_norm)
    tx, _ = jsft.build_optimizer(jsft.SFTConfig(**args), 6)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt, _ = tsft.build_optimizer(tsft.SFTConfig(**args), 6, tp)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        for got, want in zip(tp, jp):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-6)


def test_sft_trainer_matches_jax(model_pair, tmp_path):
    """Five steps of packed SFT with accumulation 2 (micro losses divided
    by the group's global token count) from the same LoRA init: equal
    per-step losses (1e-4 relative, f32 through AdamW updates) and learning
    rates, and trained adapters within 1e-3 relative L2."""
    (jcfg, jparams, jlora), (tcfg, tparams) = model_pair
    docs = _docs(24, 10, 60, seed=3)
    kw = dict(per_device_train_batch_size=1, gradient_accumulation_steps=2,
              max_steps=5, max_seq_length=T, warmup_steps=1,
              learning_rate=5e-3, logging_steps=1)
    tlora = _torch_lora(jlora)   # before JAX trains: its step donates
    jmodel = JModel(cfg=jcfg, params=jparams, max_seq_length=T,
                    lora=jax.tree_util.tree_map(jnp.copy, jlora))
    jtr = jsft.SFTTrainer(jmodel, train_dataset=docs, args=jsft.SFTConfig(
        output_dir=str(tmp_path / "jax"), **kw))
    jtr.train()
    tmodel = TModel(cfg=tcfg, params=tparams, lora=tlora, max_seq_length=T,
                    gc_mode="offload")
    ttr = tsft.SFTTrainer(tmodel, train_dataset=docs, args=tsft.SFTConfig(
        output_dir=str(tmp_path / "torch"), **kw))
    out = ttr.train()
    assert out.global_step == 5 and ttr._segment_bound == jtr._segment_bound
    assert len(ttr._batches) == len(jtr._batches) >= 4
    for je, te in zip(jtr.state_log, ttr.state_log):
        assert je["step"] == te["step"]
        np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-4)
        np.testing.assert_allclose(te["learning_rate"], je["learning_rate"],
                                   rtol=1e-6)
    assert len(ttr.state_log) == 5
    trained = lora_to_numpy(tmodel.lora)
    for jlayer, tlayer in zip(jmodel.lora["layers"], trained["layers"]):
        for name, jw in jlayer.items():
            for part in ("a", "b"):
                want = np.asarray(getattr(jw, part))
                got = getattr(tlayer[name], part)
                rel = np.linalg.norm(got - want) / np.linalg.norm(want)
                assert rel < 1e-3, (name, part, rel)


def test_get_peft_model_sets_gc_mode(model_pair):
    (_, _, _), (tcfg, tparams) = model_pair
    for gc, want in (("unsloth", "offload"), (True, True), (False, False),
                     ("layer", True)):
        m = TModel(cfg=tcfg, params=tparams)
        assert m.get_peft_model(r=2, use_gradient_checkpointing=gc).gc_mode \
            == want


def test_trainer_refuses_unported_options(model_pair, tmp_path):
    """What is still not ported raises NotImplementedError naming it:
    full fine-tuning over an NF4 base (no LoRA tree on the NF4 params),
    ``loftq_config`` and ``qat_scheme`` on get_peft_model, and
    ``stack_layers`` and ``qat_scheme`` (with full fine-tuning) on
    from_pretrained; ``save_steps`` and GaLore, refused before, now run
    (tests/test_torch_full_ft.py)."""
    from unsloth_tpu_torch.models.loader import FastLanguageModel

    _, (tcfg, tparams) = model_pair
    model = TModel(cfg=tcfg, params=tparams, max_seq_length=T)
    tr = tsft.SFTTrainer(model, train_dataset=_docs(4, 10, 20, 0),
                         args=tsft.SFTConfig(output_dir=str(tmp_path),
                                             max_seq_length=T))
    with pytest.raises(NotImplementedError, match="NF4 base"):
        tr.train()
    lora_model = TModel(cfg=tcfg, params=tparams, max_seq_length=T)
    for kw, name in ((dict(loftq_config={"loftq_bits": 4}), "loftq_config"),
                     (dict(qat_scheme="int4"), "qat_scheme")):
        with pytest.raises(NotImplementedError, match=name):
            FastLanguageModel.get_peft_model(lora_model, r=4, **kw)
    assert lora_model.lora is None
    for kw, name in ((dict(stack_layers=True), "stack_layers"),
                     (dict(qat_scheme="int4", full_finetuning=True),
                      "qat_scheme")):
        with pytest.raises(NotImplementedError, match=name):
            FastLanguageModel.from_pretrained(str(tmp_path), device="cpu",
                                              **kw)