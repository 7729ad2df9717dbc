"""GRPO in the PyTorch port against the JAX package, on the CPU in f32: the
shared-prefix mask and K18's prefix form (the plain versions against
JAX's reference and its splash kernel in interpret mode, the tile skips,
the row-wise check against two faults, the dispatch off the CPU),
selective_log_softmax, the losses and advantages, the three batch
layouts, log-probabilities and LoRA gradients through a tiny Llama
checkpoint loaded by both packages, fanned-out generate, and
GRPOTrainer / RLOOTrainer steps on fixed rollouts."""

import dataclasses
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.helpers import make_hf_checkpoint
from tests.test_torch_head_dims import _meta, fake_kernels  # noqa: F401
from tests.test_torch_unpacked import _nonzero_lora
from unsloth_tpu.inference.generate import SamplingParams as JSampling
from unsloth_tpu.inference.generate import generate as jgenerate
from unsloth_tpu.models import hf_loader as jloader
from unsloth_tpu.models.config import ModelConfig as JConfig
from unsloth_tpu.models.loader import LanguageModel as JModel
from unsloth_tpu.ops.attention import _tpu_splash as jsplash
from unsloth_tpu.ops.attention import attention_ref as jattention_ref
from unsloth_tpu.ops.attention import prefix_mask_array as jprefix_mask
from unsloth_tpu.ops.fused_ce_linear import \
    selective_log_softmax as jselective
from unsloth_tpu.trainer import grpo as jgrpo
from unsloth_tpu_torch import FastLanguageModel
from unsloth_tpu_torch.inference.generate import SamplingParams as TSampling
from unsloth_tpu_torch.inference.generate import generate as tgenerate
from unsloth_tpu_torch.interop import (lora_from_numpy, lora_to_numpy,
                                       params_from_numpy)
from unsloth_tpu_torch.models.loader import LanguageModel as TModel
from unsloth_tpu_torch.ops import flash_attention as tfa
from unsloth_tpu_torch.ops import splash_attention as tsa
from unsloth_tpu_torch.ops.fused_ce_linear import \
    selective_log_softmax as tselective
from unsloth_tpu_torch.trainer import grpo as tgrpo
from unsloth_tpu_torch.trainer.sft import lora_leaves

tatt = importlib.import_module("unsloth_tpu_torch.ops.attention")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the mask and K18's prefix form
# ---------------------------------------------------------------------------

LAYOUT = (128, 2, 128)          # the layout of JAX's splash prefix test


def _prefix_inputs(seed=3, hq=4, hkv=2, d=128):
    """q, k, v, dout and the segment ids of one row of LAYOUT: a prompt
    left-padded by 40 slots, a first completion of 90 tokens (shorter than
    its region), a full second one (tests/test_ops_splash.py:71-91)."""
    P, G, L = LAYOUT
    t = P + G * L
    rng = np.random.default_rng(seed)
    q, dout = (rng.standard_normal((1, t, hq, d)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((1, t, hkv, d)).astype(np.float32)
            for _ in range(2))
    seg = chip_smoke.prefix_segments(LAYOUT, P - 40, (90, L)).numpy()
    return q, k, v, dout, seg


@pytest.mark.parametrize("layout", [(4, 2, 3), (128, 2, 128), (37, 4, 20),
                                    (0, 3, 5)])
def test_prefix_mask_array_matches_jax(layout):
    np.testing.assert_array_equal(tatt.prefix_mask_array(*layout),
                                  jprefix_mask(*layout))


#: (query tile, kv tile): PR 8's 64 x 64 and each Hopper kernel's (K18
#: runs on K16's kernels, ops/flash_attention.KERNEL_TILES)
PREFIX_TILES = [(64, 64)] + sorted({
    tiles for by_d in tfa.KERNEL_TILES.values() for tiles in by_d.values()})
#: the pairs the prefix rule leaves of causal's at (256, 6, 896), by tiles
PREFIX_PAIRS = {(64, 64): (976, 3916), (128, 128): (255, 990),
                (128, 64): (510, 1980), (64, 128): (510, 1980),
                (128, 32): (1020, 3960), (32, 64): (1952, 7832)}


@pytest.mark.parametrize("bq,bk", PREFIX_TILES)
@pytest.mark.parametrize("layout", [(256, 6, 896), (128, 2, 128),
                                    (100, 3, 70), (37, 4, 20), (5, 5, 5)])
def test_prefix_tile_skips_are_exact(layout, bq, bk):
    """The kernels' tile rule (``chip_smoke.layout_skips``, the prefix
    layout's skip in ``pair_class<true>`` of csrc/hopper_tiles.cuh, which
    the card's tile counts are held to): a causal (query tile, kv tile)
    pair of ``bq`` x ``bk`` tokens is skipped iff the layout's mask holds
    no valid pair in it, for layouts whose edges do and do not fall on
    tile edges; at GRPO's (256, 6, 896) that leaves 976 of causal's 3,916
    pairs at 64 x 64 tiles, 255 of 990 at the forward's 128 x 128."""
    P, G, L = layout
    t = P + G * L
    m = tatt.prefix_mask_array(*layout)
    for iq in range(-(-t // bq)):
        for j in range(-(-t // bk)):
            if j * bk > iq * bq + bq - 1:
                continue                     # past causality: not visited
            pair = m[iq * bq:(iq + 1) * bq, j * bk:(j + 1) * bk]
            assert bool(pair.any()) == (
                not chip_smoke.layout_skips(P, L, iq, j, bq, bk))
    if layout == (256, 6, 896):
        assert (chip_smoke.visited_tile_pairs(t, layout, bq=bq, bk=bk),
                chip_smoke.visited_tile_pairs(t, bq=bq, bk=bk)) == \
            PREFIX_PAIRS[(bq, bk)]


@pytest.fixture(scope="module")
def jax_prefix():
    """JAX's attention_ref with the layout (out, and jax.vjp of it against
    dout), and its splash kernel with the static prefix mask in interpret
    mode (out)."""
    q, k, v, dout, seg = _prefix_inputs()
    scale = 128 ** -0.5
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    jseg = jnp.asarray(seg)

    def ref(q_, k_, v_):
        return jattention_ref(q_, k_, v_, causal=True, segment_ids=jseg,
                                  scale=scale, prefix_layout=LAYOUT)

    out, vjp = jax.vjp(ref, *args)
    grads = vjp(jnp.asarray(dout))
    splash = jsplash(*args, causal=True, segment_ids=jseg,
                              window=None, softcap=None, scale=scale,
                              interpret=True, prefix_layout=LAYOUT)
    return ((q, k, v, dout, seg), np.asarray(out),
            [np.asarray(g) for g in grads], np.asarray(splash))


def test_prefix_attention_ref_matches_jax(jax_prefix):
    """The port's attention_ref with the layout, at every position (f32,
    1e-5), and its route under prefix_attention on the CPU."""
    (q, k, v, _, seg), want, _, _ = jax_prefix
    got = tatt.attention_ref(_t(q), _t(k), _t(v), segment_ids=_t(seg),
                             scale=128 ** -0.5, prefix_layout=LAYOUT)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    with tatt.prefix_attention(LAYOUT):
        routed = tatt.attention(_t(q), _t(k), _t(v), segment_ids=_t(seg),
                                scale=128 ** -0.5)
    np.testing.assert_array_equal(routed.numpy(), got.numpy())


def test_prefix_splash_plain_matches_jax(jax_prefix):
    """K18's plain versions with the layout (what the card's kernels are
    held to): out against JAX's reference and against JAX's splash kernel
    in interpret mode on the real rows (2e-3, JAX's own tolerance; the
    reference at every position, f32 1e-5), and dq, dk, dv against
    jax.vjp of the reference (1e-4 of the largest value)."""
    (q, k, v, dout, seg), want, want_g, splash = jax_prefix
    real = seg[0].astype(bool)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    got = tsa.splash_attention(*leaves, _t(seg), scale=128 ** -0.5,
                               prefix_layout=LAYOUT)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy()[0][real],
                               splash[0][real], atol=2e-3, rtol=2e-3)
    torch.autograd.backward(got, _t(dout))
    for x, w in zip(leaves, want_g):
        assert np.abs(x.grad.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_prefix_check_rejects_faults():
    """chip_smoke's row-wise check of K18's prefix form, on the plain
    versions (f32): the reference rounded to bf16 passes it, and the
    region rule dropped (completions see each other) and the prefix
    dropped (completions miss the prompt) fail it in every tensor."""
    q, k, v, dout, seg = (_t(x) for x in _prefix_inputs(seed=4, d=64))
    opts = dict(window=None, softcap=None, scale=0.125, prefix_layout=LAYOUT)
    out, lse = tsa.splash_attention_fwd_ref(q, k, v, seg, **opts)
    want = (out,) + tsa.splash_attention_bwd_ref(q, k, v, seg, out, lse, dout,
                                                 **opts)
    for x in want:
        assert chip_smoke.attn_row_err(x.to(torch.bfloat16), x) <= \
            chip_smoke.ATTN_ROW_TOL
    res = chip_smoke.prefix_fault_errs(q, k, v, seg, dout, 0.125, LAYOUT,
                                       want)
    assert set(res) == {"region rule dropped", "prefix dropped"}
    for fault, errs in res.items():
        assert set(errs) == {"out", "dq", "dk", "dv"}
        for name, (err, _) in errs.items():
            assert err > chip_smoke.ATTN_ROW_TOL, (fault, name, err)


def test_prefix_dispatch_off_cpu(fake_kernels):  # noqa: F811
    """Off the CPU, a row under prefix_attention reaches K18's three
    kernels (no plain version runs); the layout with a softcap or with
    sinks raises, naming JAX's masked reference; a window beside an
    explicit layout raises in the wrapper."""
    P, G, L = LAYOUT
    t = P + G * L
    q, k, v = _meta(1, t, 8, 128), _meta(1, t, 2, 128), _meta(1, t, 2, 128)
    seg = torch.empty((1, t), device="meta", dtype=torch.int32)
    with tatt.prefix_attention(LAYOUT):
        out = tatt.attention(q, k, v, segment_ids=seg)
    out.backward(torch.empty_like(out))
    assert fake_kernels.calls == [("unsloth_splash_attn_fwd", 128),
                                  ("unsloth_splash_attn_dq", 128),
                                  ("unsloth_splash_attn_dkv", 128)]
    qd, kd = q.detach(), k.detach()
    with pytest.raises(NotImplementedError, match="masked reference"):
        tatt.attention(qd, kd, kd, segment_ids=seg, softcap=50.0,
                       prefix_layout=LAYOUT)
    with tatt.prefix_attention(LAYOUT), \
            pytest.raises(NotImplementedError, match="masked reference"):
        tatt.attention(qd, kd, kd, segment_ids=seg,
                       sinks=torch.empty((8,), device="meta"))
    with pytest.raises(ValueError, match="window"):
        tsa.splash_attention(qd, kd, kd, seg, window=64,
                             prefix_layout=LAYOUT)


# ---------------------------------------------------------------------------
# selective_log_softmax, the losses and the advantages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("softcap,logit_scale", [(None, None), (20.0, None),
                                                 (None, 0.7), (20.0, 1.5)])
def test_selective_log_softmax_matches_jax(softcap, logit_scale):
    """Values and d(sum g * logp)/d hidden against JAX's, chunk 8 over 27
    rows (a ragged last chunk), -100 rows giving 0; f32 1e-5."""
    rng = np.random.default_rng(0)
    n, d, v = 27, 16, 64
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.8).astype(np.float32)
    ids = rng.integers(0, v, n).astype(np.int32)
    ids[[0, 5, 26]] = -100
    g = rng.standard_normal(n).astype(np.float32)
    opts = dict(softcap=softcap, logit_scale=logit_scale, chunk_size=8)

    def jf(h_):
        return jselective(h_, jnp.asarray(w), jnp.asarray(ids), **opts)

    want = np.asarray(jf(jnp.asarray(h)))
    want_g = np.asarray(jax.grad(lambda h_: jnp.sum(
        jf(h_) * jnp.asarray(g)))(jnp.asarray(h)))
    th = _t(h).requires_grad_(True)
    got = tselective(th, _t(w), _t(ids), **opts)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    assert np.all(got.detach().numpy()[[0, 5, 26]] == 0)
    (got * _t(g)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), want_g, atol=1e-5, rtol=1e-5)


def _loss_inputs(seed=0, n=6, t=10):
    rng = np.random.default_rng(seed)
    lp = -np.abs(rng.standard_normal((n, t))).astype(np.float32)
    old = (lp + 0.3 * rng.standard_normal((n, t))).astype(np.float32)
    ref = (lp + 0.2 * rng.standard_normal((n, t))).astype(np.float32)
    adv = rng.standard_normal(n).astype(np.float32)
    mask = (rng.random((n, t)) < 0.7).astype(np.int32)
    mask[0] = 0                                   # an empty completion
    return lp, old, ref, adv, mask


def _value_and_grad_pair(jfn, tfn, lp):
    """(JAX value, grad) and (port value, grad) of a loss in the policy
    logps."""
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(lp))
    tl = _t(lp).requires_grad_(True)
    tv = tfn(tl)
    tv.backward()
    return (float(jv), np.asarray(jg)), (float(tv.detach()), tl.grad.numpy())


def _assert_pair(jpair, tpair):
    np.testing.assert_allclose(tpair[0], jpair[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tpair[1], jpair[1], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("loss_type", ["grpo", "bnpo", "dr_grpo"])
@pytest.mark.parametrize("level", ["token", "sequence", "sequence_token"])
def test_grpo_loss_matches_jax(loss_type, level):
    """grpo_loss and its gradient in the policy logps, each loss type and
    importance-sampling level, with the KL term and an asymmetric clip;
    f32 1e-6 relative."""
    lp, old, ref, adv, mask = _loss_inputs()
    kw = dict(beta=0.04, epsilon=0.2, epsilon_high=0.28, loss_type=loss_type,
              max_completion_length=12, importance_sampling_level=level)
    jpair, tpair = _value_and_grad_pair(
        lambda x: jgrpo.grpo_loss(x, jnp.asarray(old), jnp.asarray(ref),
                                  jnp.asarray(adv), jnp.asarray(mask), **kw),
        lambda x: tgrpo.grpo_loss(x, _t(old), _t(ref), _t(adv), _t(mask),
                                  **kw), lp)
    _assert_pair(jpair, tpair)


def test_packed_and_grouped_losses_match_jax():
    """grpo_loss_packed and grpo_loss_grouped (in-row and first-token
    terms, with and without the reference) and their gradients in the
    policy logps; f32 1e-6 relative."""
    lp, old, ref, _, _ = _loss_inputs(seed=1, n=3, t=12)
    rng = np.random.default_rng(2)
    adv_tok, w_tok = (rng.standard_normal(lp.shape).astype(np.float32)
                      for _ in range(2))
    flp, fold, fref = (lp[:, :2] - 0.1 * i for i in range(3))
    first_adv, first_w = adv_tok[:, :2], np.abs(w_tok[:, :2])
    jp = jgrpo.PackedGRPOBatch(*(jnp.zeros(lp.shape, jnp.int32)
                                 for _ in range(4)), jnp.asarray(adv_tok),
                               jnp.asarray(w_tok))
    tp = tgrpo.PackedGRPOBatch(*(torch.zeros(lp.shape, dtype=torch.int32)
                                 for _ in range(4)), _t(adv_tok), _t(w_tok))
    for beta, with_ref in ((0.04, True), (0.0, False)):
        kw = dict(beta=beta, epsilon=0.2)
        jr = jnp.asarray(ref) if with_ref else None
        tr = _t(ref) if with_ref else None
        _assert_pair(*_value_and_grad_pair(
            lambda x: jgrpo.grpo_loss_packed(x, jnp.asarray(old), jr, jp,
                                             **kw),
            lambda x: tgrpo.grpo_loss_packed(x, _t(old), tr, tp, **kw), lp))
        zeros = np.zeros(lp.shape, np.int32)
        jg = jgrpo.GroupedGRPOBatch(
            *(jnp.asarray(zeros) for _ in range(4)),
            jnp.zeros((3, 2), jnp.int32), jnp.asarray(adv_tok),
            jnp.asarray(w_tok), jnp.asarray(first_adv), jnp.asarray(first_w),
            layout=(4, 2, 4))
        tg = tgrpo.GroupedGRPOBatch(
            *(_t(zeros) for _ in range(4)), torch.zeros((3, 2),
                                                        dtype=torch.int32),
            _t(adv_tok), _t(w_tok), _t(first_adv), _t(first_w),
            layout=(4, 2, 4))
        jref = (jnp.asarray(ref), jnp.asarray(fref)) if with_ref else None
        tref = (_t(ref), _t(fref)) if with_ref else None
        _assert_pair(*_value_and_grad_pair(
            lambda x: jgrpo.grpo_loss_grouped(
                (x, jnp.asarray(flp)), (jnp.asarray(old), jnp.asarray(fold)),
                jref, jg, epsilon_high=0.3, **kw),
            lambda x: tgrpo.grpo_loss_grouped(
                (x, _t(flp)), (_t(old), _t(fold)), tref, tg,
                epsilon_high=0.3, **kw), lp))


@pytest.mark.parametrize("scale", [True, False])
def test_advantages_match_jax(scale):
    rewards = np.random.default_rng(3).standard_normal(12)
    rewards[6:9] = 1.0                            # a group of equal rewards
    for fn in ("group_advantages", "loo_advantages"):
        got = getattr(tgrpo, fn)(rewards, 3, scale)
        want = getattr(jgrpo, fn)(rewards, 3, scale)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the batch layouts
# ---------------------------------------------------------------------------

class CharTokenizer:
    """One character is one token (its code mod 128); id 0 is EOS."""

    eos_token_id = 0
    pad_token_id = 0

    def __call__(self, text, **kw):
        return {"input_ids": [ord(c) % 128 for c in text]}

    def decode(self, ids, **kw):
        return "".join(chr(i) for i in ids if i > 0)


#: four rollouts of two prompts, two generations each: completions that
#: stopped early (EOS appended), one cut at the limit (truncated), one that
#: ends in EOS at the limit, one empty
ROLLOUT_PROMPTS = [[5, 9, 14, 3, 7, 22, 31], [40, 41, 42, 43, 44]]
ROLLOUT_COMPLETIONS = [[11, 12, 13, 14, 15, 16], list(range(60, 72)),
                       list(range(80, 91)) + [0], []]
ROLLOUT_ADV = np.array([0.5, -0.5, 1.2, -1.2], np.float32)


def _grpo_args(mod, **kw):
    return mod.GRPOConfig(max_prompt_length=16, max_completion_length=12,
                          num_generations=2, beta=0.04, report_to="none",
                          **kw)


@pytest.mark.parametrize("loss_type", ["grpo", "bnpo", "dr_grpo"])
@pytest.mark.parametrize("mask_truncated", [False, True])
def test_batch_layouts_match_jax(tmp_path, loss_type, mask_truncated):
    """The unpacked, packed and grouped batches are JAX's arrays, element
    for element, and the grouped layout (128, 2, 128); the port's are on
    the model's device."""
    jm = JModel(cfg=JConfig(vocab_size=128), params={})
    tm = TModel(cfg=None, params={"embed": torch.zeros(1)})
    prompts = [p for p in ROLLOUT_PROMPTS for _ in range(2)]
    trainers = []
    for mod, model in ((jgrpo, jm), (tgrpo, tm)):
        args = _grpo_args(mod, loss_type=loss_type,
                             mask_truncated_completions=mask_truncated,
                             output_dir=str(tmp_path / mod.__name__))
        trainers.append(mod.GRPOTrainer(model, reward_funcs=[],
                                        args=args, train_dataset=[],
                                        processing_class=CharTokenizer()))
    jtr, ttr = trainers
    for build in ("_build_batch", "_build_packed_batch",
                  "_build_grouped_batch"):
        jb = getattr(jtr, build)(prompts, ROLLOUT_COMPLETIONS, ROLLOUT_ADV)
        tb = getattr(ttr, build)(prompts, ROLLOUT_COMPLETIONS, ROLLOUT_ADV)
        for f in dataclasses.fields(tb):
            got, want = getattr(tb, f.name), getattr(jb, f.name)
            if f.name == "layout":
                assert got == want == (128, 2, 128)
                continue
            assert got.device == tm.device, (build, f.name)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{build} {f.name}")


# ---------------------------------------------------------------------------
# a tiny Llama checkpoint loaded by both packages
# ---------------------------------------------------------------------------

TINY_LLAMA = dict(
    chip_smoke.LLAMA_31_8B_CONFIG, hidden_size=128, intermediate_size=256,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    head_dim=32, vocab_size=300, max_position_embeddings=1024,
    eos_token_id=2, bos_token_id=1,
    rope_scaling=dict(chip_smoke.LLAMA_31_8B_CONFIG["rope_scaling"],
                      original_max_position_embeddings=64))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX model, port model, LoRA numpy tree with nonzero B): one
    checkpoint directory loaded by each package (NF4 on load, f32), the
    port holding the JAX package's NF4 tree carried byte for byte."""
    path = str(tmp_path_factory.mktemp("tiny_llama"))
    make_hf_checkpoint(path, TINY_LLAMA)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(TINY_LLAMA, fh)
    jcfg = JConfig.from_hf_config(TINY_LLAMA)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNSLOTH_VALIDATE_CHECKPOINT", "0")
        jparams = jloader.load_params(path, jcfg, dtype=jnp.float32,
                                      load_in_4bit=True)
    tmodel, _ = FastLanguageModel.from_pretrained(
        path, load_in_4bit=True, dtype=torch.float32, device="cpu")
    tmodel.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    lora_np = jax.tree_util.tree_map(np.asarray, _nonzero_lora(jcfg))
    jmodel = JModel(cfg=jcfg, params=jparams)
    return jmodel, tmodel, lora_np


def _jlora(lora_np):
    return jax.tree_util.tree_map(jnp.asarray, lora_np)


def _grad_lora(lora_np):
    tl = lora_from_numpy(lora_np, "cpu")
    for p in lora_leaves(tl):
        p.requires_grad_(True)
    return tl


def _assert_lora_grads(tlora, jgrads, tol=1e-4):
    """Each LoRA gradient leaf within ``tol`` of its largest value (fp32
    sums in other orders through two layers)."""
    for jlayer, tlayer in zip(jgrads["layers"], tlora["layers"]):
        for name, jw in jlayer.items():
            for part in ("a", "b"):
                want = np.asarray(getattr(jw, part))
                got = getattr(tlayer[name], part).grad.numpy()
                err = np.abs(got - want).max() / np.abs(want).max()
                assert err < tol, (name, part, err)


def _trainer_pair(pair, tmp_path, loss_type="grpo"):
    """(JAX trainer, port trainer) over the pair, to build batches."""
    jmodel, tmodel, _ = pair
    return [mod.GRPOTrainer(model, reward_funcs=[], train_dataset=[],
                            args=_grpo_args(
                                mod, loss_type=loss_type,
                                output_dir=str(tmp_path / mod.__name__)),
                            processing_class=CharTokenizer())
            for mod, model in ((jgrpo, jmodel), (tgrpo, tmodel))]


def test_logps_match_jax(pair, tmp_path):
    """grpo_per_token_logps on the unpacked batch and grpo_grouped_logps
    (in-row and first-token) on the grouped one, with the LoRA tree and
    with None (the reference policy), against JAX; f32 2e-5."""
    jmodel, tmodel, lora_np = pair
    jtr, ttr = _trainer_pair(pair, tmp_path)
    prompts = [p for p in ROLLOUT_PROMPTS for _ in range(2)]
    args = (prompts, ROLLOUT_COMPLETIONS, ROLLOUT_ADV)
    jub, tub = jtr._build_batch(*args), ttr._build_batch(*args)
    jgb, tgb = jtr._build_grouped_batch(*args), ttr._build_grouped_batch(*args)
    jflat = jax.jit(lambda p, lo, b: jgrpo.grpo_per_token_logps(
        p, lo, b.input_ids, b.logp_targets, jmodel.cfg))
    jgrouped = jax.jit(lambda p, lo, b: jgrpo.grpo_grouped_logps(
        p, lo, b, jmodel.cfg))
    for jl, tl in ((_jlora(lora_np), lora_from_numpy(lora_np, "cpu")),
                   (None, None)):
        want = jflat(jmodel.params, jl, jub)
        with torch.no_grad():
            got = tgrpo.grpo_per_token_logps(tmodel.params, tl,
                                             tub.input_ids, tub.logp_targets,
                                             tmodel.cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        want = jgrouped(jmodel.params, jl, jgb)
        with torch.no_grad():
            got = tgrpo.grpo_grouped_logps(tmodel.params, tl, tgb,
                                           tmodel.cfg)
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=2e-5)


def test_grouped_loss_lora_grads_match_jax(pair, tmp_path):
    """The grouped loss (old = the policy detached, the reference pass with
    LoRA off) and d loss / d every LoRA leaf against jax.grad, f32: loss
    1e-5 relative, each leaf 1e-4 of its largest value; the recompute in
    the backward runs outside prefix_attention and keeps the layout."""
    jmodel, tmodel, lora_np = pair
    jtr, ttr = _trainer_pair(pair, tmp_path)
    prompts = [p for p in ROLLOUT_PROMPTS for _ in range(2)]
    args = (prompts, ROLLOUT_COMPLETIONS, ROLLOUT_ADV)
    jgb, tgb = jtr._build_grouped_batch(*args), ttr._build_grouped_batch(*args)
    kw = dict(beta=0.04, epsilon=0.2)
    jref = jax.jit(lambda p, b: jgrpo.grpo_grouped_logps(
        p, None, b, jmodel.cfg))(jmodel.params, jgb)

    def jloss(lora):
        pol = jgrpo.grpo_grouped_logps(jmodel.params, lora, jgb, jmodel.cfg)
        return jgrpo.grpo_loss_grouped(
            pol, jax.lax.stop_gradient(pol), jref, jgb, **kw)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(_jlora(lora_np))
    tlora = _grad_lora(lora_np)
    with torch.no_grad():
        tref = tgrpo.grpo_grouped_logps(tmodel.params, None, tgb, tmodel.cfg)
    pol = tgrpo.grpo_grouped_logps(tmodel.params, tlora, tgb, tmodel.cfg)
    tl = tgrpo.grpo_loss_grouped(pol, tuple(x.detach() for x in pol), tref,
                                 tgb, **kw)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _assert_lora_grads(tlora, jg)


@pytest.mark.parametrize("loss_type", ["grpo", "bnpo", "dr_grpo"])
def test_grouped_loss_equals_unpacked(pair, tmp_path, loss_type):
    """Inside the port, the shared-prefix layout reproduces the unpacked
    loss of the same rollouts (tests/test_trainer_grpo.py:250-295's check,
    rtol 2e-4): the prompt is attended once, every completion token's logp
    and weight are the same; and so every LoRA gradient (f32: 1e-4 of
    its largest value)."""
    _, tmodel, lora_np = pair
    _, ttr = _trainer_pair(pair, tmp_path, loss_type)
    prompts = [p for p in ROLLOUT_PROMPTS for _ in range(2)]
    args = (prompts, ROLLOUT_COMPLETIONS[:3] + [[7, 8, 9]], ROLLOUT_ADV)
    out = []
    for build in (ttr._build_batch, ttr._build_grouped_batch):
        batch = build(*args)
        tmodel.lora = _grad_lora(lora_np)
        with torch.no_grad():
            ref = ttr._logps(batch, None)
        loss = ttr._loss(batch, None, ref)
        loss.backward()
        out.append((float(loss.detach()), [p.grad.numpy() for p in
                                           lora_leaves(tmodel.lora)]))
    tmodel.lora = None
    (loss_u, grads_u), (loss_g, grads_g) = out
    np.testing.assert_allclose(loss_g, loss_u, rtol=2e-4, atol=1e-6)
    for gg, gu in zip(grads_g, grads_u):
        assert np.abs(gg - gu).max() <= 1e-4 * np.abs(gu).max()


# ---------------------------------------------------------------------------
# fanned-out generate
# ---------------------------------------------------------------------------

GEN_PROMPTS = [[5, 9, 14, 3, 7, 22, 31, 40, 8], [40, 41, 42]]


def test_fanout_greedy_matches_jax(pair):
    """num_return_sequences=3, greedy, f32: the port's ids equal JAX's,
    grouped by prompt, and each group repeats the single-stream output."""
    jmodel, tmodel, lora_np = pair
    jm = JModel(cfg=jmodel.cfg, params=jmodel.params, lora=_jlora(lora_np))
    tm = TModel(cfg=tmodel.cfg, params=tmodel.params,
                lora=lora_from_numpy(lora_np, "cpu"))
    want = jgenerate(jm, GEN_PROMPTS, JSampling(max_tokens=6),
                     return_token_ids=True, num_return_sequences=3)
    got = tgenerate(tm, GEN_PROMPTS, TSampling(max_tokens=6),
                    return_token_ids=True, num_return_sequences=3)
    assert got == want and len(got) == 6
    single = tgenerate(tm, GEN_PROMPTS, TSampling(max_tokens=6),
                       return_token_ids=True)
    assert got == [s for s in single for _ in range(3)]


def test_generate_builds_no_graph(pair, monkeypatch):
    """Rollouts run inside GRPO's loop while the LoRA tensors require
    gradients: generate must build no autograd graph (on the card one
    would hold every decode step's activations)."""
    tgen = importlib.import_module("unsloth_tpu_torch.inference.generate")

    _, tmodel, lora_np = pair
    tm = TModel(cfg=tmodel.cfg, params=tmodel.params,
                lora=_grad_lora(lora_np))
    seen = []
    cache_fn = tgen.forward_with_cache

    def spy(*a, **kw):
        h, cache = cache_fn(*a, **kw)
        seen.append(h.requires_grad or torch.is_grad_enabled())
        return h, cache

    monkeypatch.setattr(tgen, "forward_with_cache", spy)
    out = tgenerate(tm, GEN_PROMPTS, TSampling(max_tokens=4),
                    return_token_ids=True, num_return_sequences=2)
    assert len(out) == 4 and len(seen) >= 2 and not any(seen)


def test_fanout_sampling_is_seeded(pair):
    """Sampling with a seed gives the same streams twice, and a prompt's
    streams differ from each other."""
    _, tmodel, lora_np = pair
    tm = TModel(cfg=tmodel.cfg, params=tmodel.params,
                lora=lora_from_numpy(lora_np, "cpu"))
    sp = TSampling(max_tokens=8, temperature=1.0, seed=11)
    a = tgenerate(tm, GEN_PROMPTS, sp, return_token_ids=True,
                  num_return_sequences=4)
    b = tgenerate(tm, GEN_PROMPTS, sp, return_token_ids=True,
                  num_return_sequences=4)
    assert a == b and len(a) == 8
    for g in range(2):
        assert len({tuple(s) for s in a[4 * g:4 * g + 4]}) > 1


# ---------------------------------------------------------------------------
# the trainers on fixed rollouts
# ---------------------------------------------------------------------------

#: each round's completions (the prompts are the dataset's, two a round)
ROUNDS = [[[11, 12, 13, 14, 15, 16], list(range(60, 72)),
           [20, 21, 22], [33, 34, 35, 36, 37, 38, 39, 0]],
          [[70, 71, 72, 73], [9, 8, 7, 6, 5, 4, 3, 2, 1, 0],
           list(range(100, 112)), [44, 45]]]


def _reward(prompts=None, completions=None, **kw):
    return [sum(map(ord, c)) % 17 / 17.0 + 0.1 * len(c) for c in completions]


def _run_trainer(mod, model, cls, tmp_path, **kw):
    args = (mod.RLOOConfig if cls == "RLOOTrainer" else mod.GRPOConfig)(
        per_device_train_batch_size=2, num_generations=2,
        max_prompt_length=16, max_completion_length=12, beta=0.04,
        learning_rate=2e-2, warmup_steps=0, logging_steps=1,
        output_dir=str(tmp_path / mod.__name__), report_to="none", **kw)
    ds = [{"prompt": "abcdefg"}, {"prompt": "xyz"}]
    tr = getattr(mod, cls)(model, reward_funcs=[_reward], args=args,
                           train_dataset=ds,
                           processing_class=CharTokenizer())
    tok = CharTokenizer()
    rounds = iter(ROUNDS)

    def fixed(prompts):
        ids = [tok(p)["input_ids"] for p in prompts]
        return [p for p in ids for _ in range(2)], next(rounds)

    tr._generate_batch = fixed
    out = tr.train()
    return tr, out


@pytest.mark.parametrize("cls,kw", [
    ("GRPOTrainer", dict(prefix_grouping=True, max_steps=2)),
    ("GRPOTrainer", dict(prefix_grouping=False, max_steps=2)),
    ("RLOOTrainer", dict(prefix_grouping=True, max_steps=1)),
])
def test_trainer_matches_jax(pair, tmp_path, cls, kw):
    """GRPOTrainer (two rounds, grouped and unpacked) and RLOOTrainer (one)
    from the same LoRA on the same fixed rollouts: equal logged losses
    (1e-4 relative) and rewards, and trained adapters within 1e-3
    relative L2 of JAX's (f32 through AdamW updates)."""
    jmodel, tmodel, lora_np = pair
    jm = JModel(cfg=jmodel.cfg, params=jmodel.params, lora=_jlora(lora_np))
    tm = TModel(cfg=tmodel.cfg, params=tmodel.params,
                lora=lora_from_numpy(lora_np, "cpu"))
    jtr, jout = _run_trainer(jgrpo, jm, cls, tmp_path, **kw)
    ttr, tout = _run_trainer(tgrpo, tm, cls, tmp_path, **kw)
    assert tout.global_step == jout.global_step == kw["max_steps"]
    assert len(ttr.state_log) == kw["max_steps"]
    for je, te in zip(jtr.state_log, ttr.state_log):
        assert je["step"] == te["step"]
        np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(te["reward"], je["reward"], rtol=1e-12)
    trained = lora_to_numpy(tm.lora)
    for jlayer, tlayer in zip(jm.lora["layers"], trained["layers"]):
        for name, jw in jlayer.items():
            for part in ("a", "b"):
                want = np.asarray(getattr(jw, part))
                got = getattr(tlayer[name], part)
                rel = np.linalg.norm(got - want) / np.linalg.norm(want)
                assert rel < 1e-3, (name, part, rel)
    assert not any(p.requires_grad for p in lora_leaves(tm.lora))
