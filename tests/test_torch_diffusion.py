"""Text diffusion in the PyTorch port against the JAX package, on the CPU
in f32: the non-causal forms of K16 (the bundled flash kernels with
causal=False) and K18 (splash with a FullMask and a softcap) through their
plain versions against the Pallas kernels in interpret mode; the
dispatcher's non-causal routes (the CPU reference against JAX's
``attention_ref``; off the CPU, the kernel wrappers of the non-causal
forms, never the plain versions, and a window without causality raising);
chip_smoke's row-wise check rejecting the causal output of a non-causal
case; and models/diffusion.py and trainer/diffusion.py: the LLaDA forward
process, the loader, bidirectionality, the masked-denoising loss and its
gradients (JAX's own mask draw fed through ``noise=``), greedy iterative
unmasking, and DiffusionTrainer's steps."""

import copy
import dataclasses
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from helpers import TINY_LLAMA, make_hf_checkpoint
from unsloth_tpu.models import diffusion as jdiff
from unsloth_tpu.models.config import ModelConfig as JConfig
from unsloth_tpu.models.loader import LanguageModel as JModel
from unsloth_tpu.models.params import init_lora_tree, init_params
from unsloth_tpu.ops.attention import _tpu_flash, _tpu_splash
from unsloth_tpu.ops.attention import attention_ref as jattention_ref
from unsloth_tpu.ops.lora import LoRAWeights
from unsloth_tpu_torch import kernels
from unsloth_tpu_torch.interop import lora_from_numpy, params_from_numpy
from unsloth_tpu_torch.models import diffusion as tdiff
from unsloth_tpu_torch.models import loader as tloader
from unsloth_tpu_torch.models.config import ModelConfig as TConfig
from unsloth_tpu_torch.models.decoder import logits_fn as tlogits_fn
from unsloth_tpu_torch.models.loader import LanguageModel as TModel
from unsloth_tpu_torch.ops import flash_attention as tfa
from unsloth_tpu_torch.ops import splash_attention as tsa
from unsloth_tpu_torch.trainer.checkpoint import named_leaves
from unsloth_tpu_torch.trainer.diffusion import DiffusionTrainer
from unsloth_tpu_torch.trainer.sft import SFTConfig, build_optimizer
from tests.test_torch_gemma2 import _splash_inputs
from tests.test_torch_unpacked import _padded_qkv

tatt = importlib.import_module("unsloth_tpu_torch.ops.attention")

MASK = 250


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_grads(got, want, tol=1e-4):
    """Each gradient within ``tol`` of its largest value (fp32 sums in other
    orders)."""
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= tol * np.abs(w).max()


def _jax_out_grads(f, q, k, v, dout):
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(dout)),
                     argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(x) for x in grads]


# ---------------------------------------------------------------------------
# K16 and K18 without causality: the plain versions against Pallas
# ---------------------------------------------------------------------------

#: id -> (head dim, query heads, kv heads): LLaDA-8B's head dim 128 with
#: GQA (4/2), and head dim 64 with Qwen2.5-0.5B's 7 query heads a kv head
FLASH_CASES = {"d128-gqa2": (128, 4, 2), "d64-gqa7": (64, 7, 1)}


@pytest.fixture(scope="module", params=list(FLASH_CASES))
def jax_flash_full(request):
    """_tpu_flash(causal=False) in interpret mode on a full and a padded
    row: out and d(sum out * dout)/d(q, k, v)."""
    d, hq, hkv = FLASH_CASES[request.param]
    q, k, v, dout, seg = _padded_qkv(seed=21, hq=hq, hkv=hkv, d=d)
    scale = d ** -0.5

    def f(q_, k_, v_):
        return _tpu_flash(q_, k_, v_, causal=False,
                          segment_ids=jnp.asarray(seg), scale=scale)

    with pltpu.force_tpu_interpret_mode():
        out, grads = _jax_out_grads(f, q, k, v, dout)
    return (q, k, v, dout, seg), out, grads


def test_flash_full_plain_forward_matches_pallas(jax_flash_full):
    """Every position, pad queries included (a pad query attends every pad
    key of its row, before and after it), f32: 1e-5."""
    (q, k, v, _, seg), want, _ = jax_flash_full
    got = tfa.flash_attention(_t(q), _t(k), _t(v), _t(seg), causal=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_flash_full_plain_grads_match_pallas(jax_flash_full):
    """dq, dk, dv (dk/dv summed over each kv head's query heads), f32:
    1e-4 of the largest value."""
    (q, k, v, dout, seg), _, want = jax_flash_full
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, _t(seg), causal=False)
    torch.autograd.backward(out, _t(dout))
    _assert_grads([x.grad.numpy() for x in (tq, tk, tv)], want)


#: id -> (head dim, query heads, kv heads, scale): LLaDA-like 128 and
#: Gemma-2's 256 with its softcap of 50
SPLASH_CASES = {"d128": (128, 4, 2, 128 ** -0.5), "d256": (256, 2, 1, 1 / 16)}


@pytest.fixture(scope="module", params=list(SPLASH_CASES))
def jax_splash_full(request):
    """_tpu_splash(causal=False, window=None, softcap=50) in interpret mode
    (splash's FullMask) on a padded and a packed row."""
    d, hq, hkv, scale = SPLASH_CASES[request.param]
    q, k, v, dout, seg = _splash_inputs(d, seed=22, hq=hq, hkv=hkv)

    def f(q_, k_, v_):
        return _tpu_splash(q_, k_, v_, causal=False,
                           segment_ids=jnp.asarray(seg), window=None,
                           softcap=50.0, scale=scale, interpret=True)

    out, grads = _jax_out_grads(f, q, k, v, dout)
    return (q, k, v, dout, seg), scale, out, grads


def test_splash_full_plain_forward_matches_pallas(jax_splash_full):
    """Output at every position, f32: 1e-5."""
    (q, k, v, _, seg), scale, want, _ = jax_splash_full
    got = tsa.splash_attention(_t(q), _t(k), _t(v), _t(seg), softcap=50.0,
                               scale=scale, causal=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_splash_full_plain_grads_match_pallas(jax_splash_full):
    """dq, dk, dv through the softcap's derivative, f32: 1e-4 of the
    largest value."""
    (q, k, v, dout, seg), scale, _, want = jax_splash_full
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tsa.splash_attention(tq, tk, tv, _t(seg), softcap=50.0,
                               scale=scale, causal=False)
    torch.autograd.backward(out, _t(dout))
    _assert_grads([x.grad.numpy() for x in (tq, tk, tv)], want)


@pytest.mark.parametrize("window,softcap", [(None, None), (None, 30.0),
                                            (16, None)])
def test_attention_noncausal_cpu_matches_jax_ref(window, softcap):
    """attention(causal=False) on the CPU is JAX's attention_ref: segment
    ids, GQA, a softcap, and a window, which the CPU reads as JAX's
    reference does (i - j < window alone), f32: 1e-5."""
    q, k, v, _, seg = _padded_qkv(seed=23, t=96, hq=4, hkv=2, d=32,
                                  n_real=(96, 60))
    want = jattention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, segment_ids=jnp.asarray(seg),
                          window=window, softcap=softcap)
    got = tatt.attention(_t(q), _t(k), _t(v), causal=False,
                         segment_ids=_t(seg), window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_check_rejects_causal_output(softcap):
    """chip_smoke's row-wise check on a non-causal case (the plain versions
    in f32, a full and a padded row): the reference rounded to bf16 passes
    it, and the causal output of the same inputs (the mask slip phase 3
    plants), a dropped kv tile, an ignored pad mask and a late-half error
    fail it in out, dq, dk and dv (the softcap's dropped derivative in dq
    and dk)."""
    q, k, v, dout, seg = (_t(x) for x in _padded_qkv(seed=24, t=192))
    q, k = q * 4, k * 4       # scores of the order of the softcap, as in
    scale = 128 ** -0.5       # phase 3: its tanh bites
    opts = dict(window=None, softcap=softcap, scale=scale)
    out, lse = tsa.splash_attention_fwd_ref(q, k, v, seg, causal=False,
                                            **opts)
    want = (out,) + tsa.splash_attention_bwd_ref(q, k, v, seg, out, lse,
                                                 dout, causal=False, **opts)
    for x in want:
        assert chip_smoke.attn_row_err(x.to(torch.bfloat16), x) <= \
            chip_smoke.ATTN_ROW_TOL
    res = chip_smoke.attn_fault_errs(q, k, v, seg, dout, scale, want,
                                     softcap=softcap, causal=False)
    assert "causal mask" in res and "kv tile dropped" in res
    for fault, errs in res.items():
        for name, (err, _) in errs.items():
            assert err > chip_smoke.ATTN_ROW_TOL, (fault, name, err)


# ---------------------------------------------------------------------------
# dispatch off the CPU (a meta tensor stands in for a CUDA one)
# ---------------------------------------------------------------------------

class _FakeLibrary:
    """Records each entry point's name and its causal flag (the one bool
    argument)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, [a for a in args
                                      if isinstance(a, bool)]))
            return 0
        return call


@pytest.fixture
def fake_kernels(monkeypatch):
    def no_plain(*a, **kw):
        raise AssertionError("a plain version ran on a tensor off the CPU")

    for mod in (tfa, tsa):
        for name in dir(mod):
            if name.endswith("_ref"):
                monkeypatch.setattr(mod, name, no_plain)
        monkeypatch.setattr(mod, "_check_kernel_inputs", lambda *a, **k: None)
        monkeypatch.setattr(mod, "_stream", lambda t: 0)
    lib = _FakeLibrary()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    return lib


@pytest.mark.parametrize("softcap,entry,counters", [
    (None, "flash", ("flash_attention_fwd_full", "flash_attention_dq_full",
                     "flash_attention_dkv_full")),
    (50.0, "splash", ("splash_attention_fwd_full",
                      "splash_attention_dq_full",
                      "splash_attention_dkv_full"))])
def test_noncausal_device_route_reaches_full_kernels(fake_kernels, softcap,
                                                     entry, counters):
    """Non-causal self-attention off the CPU launches the non-causal K16
    (no softcap) or K18 (softcap) wrappers, forward then dq and dk/dv,
    with the causal flag off, and counts them under their own names; the
    causal counters do not move."""
    mod = tfa if entry == "flash" else tsa
    b, t, hq, hkv, d = 2, 100, 4, 2, 128
    q = torch.empty((b, t, hq, d), device="meta", requires_grad=True)
    k = torch.empty((b, t, hkv, d), device="meta", requires_grad=True)
    seg = torch.ones((b, t), dtype=torch.int32, device="meta")
    causal_fns = [getattr(mod, n.replace("_full", "")) for n in counters]
    before = [getattr(mod, n).launches for n in counters]
    before_causal = [f.launches for f in causal_fns]
    out = tatt.attention(q, k, k, causal=False, segment_ids=seg,
                         softcap=softcap)
    out.sum().backward()
    names = [n for n, _ in fake_kernels.calls]
    assert names == [f"unsloth_{entry}_attn_{w}" for w in ("fwd", "dq",
                                                           "dkv")]
    assert all(flags == [False] for _, flags in fake_kernels.calls)
    assert [getattr(mod, n).launches - b0
            for n, b0 in zip(counters, before)] == [1, 1, 1]
    assert [f.launches for f in causal_fns] == before_causal


def test_noncausal_window_raises_off_cpu(fake_kernels):
    """A window without causality raises off the CPU, naming both JAX
    readings; the splash wrappers refuse it (and a prefix layout) too."""
    q = torch.empty((1, 128, 4, 128), device="meta")
    with pytest.raises(NotImplementedError, match="attention_ref"):
        tatt.attention(q, q, q, causal=False, window=32)
    with pytest.raises(NotImplementedError, match="LocalMask"):
        tsa.splash_attention(q, q, q, window=32, causal=False)
    with pytest.raises(NotImplementedError, match="prefix layout"):
        tsa.splash_attention(q, q, q, prefix_layout=(64, 2, 32),
                             causal=False)
    assert fake_kernels.calls == []


# ---------------------------------------------------------------------------
# models/diffusion.py against the JAX package
# ---------------------------------------------------------------------------

BASE = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2,
            max_position_embeddings=128, causal=False, mask_token_id=MASK)
S = 48


def _nonzero_lora(cfg, seed=7):
    tree = init_lora_tree(cfg, jax.random.PRNGKey(1), r=4, alpha=8.0)
    rng = np.random.default_rng(seed)
    for layer in tree["layers"]:
        for name, lw in list(layer.items()):
            b = rng.standard_normal(lw.b.shape).astype(np.float32) * 0.05
            layer[name] = LoRAWeights(lw.a, jnp.asarray(b), lw.scale)
    return tree


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, params, nonzero LoRA), (torch cfg, params): one random f32
    base, its head scaled up so that the greedy canvas has clear argmaxes
    and confidences."""
    jcfg = JConfig(**BASE)
    jparams = init_params(jcfg, jax.random.PRNGKey(0))
    jparams["lm_head"] = jparams["lm_head"] * 40.0
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return (jcfg, jparams, _nonzero_lora(jcfg)), (TConfig(**BASE), tparams)


def _batch(with_prompt):
    """Two padded rows (48 and 30 real tokens, pad_batch's segments 1/0 and
    positions), and a prompt of 8 and 5 tokens where asked."""
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 240, (2, S)).astype(np.int32)
    seg = np.zeros((2, S), np.int32)
    seg[0], seg[1, :30] = 1, 1
    ids[1, 30:] = 0
    batch = {"input_ids": ids, "segment_ids": seg,
             "positions": np.tile(np.arange(S, dtype=np.int32), (2, 1))}
    if with_prompt:
        pm = np.zeros((2, S), bool)
        pm[0, :8], pm[1, :5] = True, True
        batch["prompt_mask"] = pm
    return batch


def _torch_tree(tree, grad=True):
    t = lora_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    leaves = [lw for layer in t["layers"] for lw in layer.values()]
    for lw in leaves:
        lw.a.requires_grad_(grad)
        lw.b.requires_grad_(grad)
    return t


@pytest.mark.parametrize("case", ["lora", "lora-prompt", "full-ft"])
def test_diffusion_loss_and_grads_match_jax(pair, case):
    """diffusion_loss on padded rows with segment ids (pad positions scored
    when masked), with and without a prompt mask, under LoRA and under full
    fine-tuning (every param and the head trained), JAX's own mask draw
    (diffusion_mask with the same key) fed through ``noise=``. f32: loss
    within 1e-5 relative, each gradient leaf within 1e-4 of its largest
    value."""
    (jcfg, jparams, jlora), (tcfg, tparams) = pair
    batch = _batch(case == "lora-prompt")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(5)
    full = case == "full-ft"
    noise = jdiff.diffusion_mask(key, jbatch["input_ids"], MASK,
                                 prompt_mask=jbatch.get("prompt_mask"))
    if full:
        jl, jg = jax.value_and_grad(lambda p: jdiff.diffusion_loss(
            p, None, jbatch, jcfg, key, remat=False))(jparams)
        params = copy.deepcopy(tparams)
        for p in jax.tree_util.tree_leaves(params):
            p.requires_grad_(True)
        lora = None
    else:
        jl, jg = jax.value_and_grad(lambda lo: jdiff.diffusion_loss(
            jparams, lo, jbatch, jcfg, key, remat=False))(jlora)
        params, lora = tparams, _torch_tree(jlora)
    tbatch = {k: _t(v) for k, v in batch.items()}
    tnoise = tuple(_t(np.asarray(x)) for x in noise)
    tl = tdiff.diffusion_loss(params, lora, tbatch, tcfg,
                              noise=(tnoise[0].long(), *tnoise[1:]),
                              remat=True)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    if full:
        pairs = [(np.asarray(jg["lm_head"]), params["lm_head"].grad),
                 (np.asarray(jg["embed"]), params["embed"].grad)]
        for jlayer, tlayer in zip(jg["layers"], params["layers"]):
            pairs += [(np.asarray(jw), tlayer[n].grad)
                      for n, jw in jlayer.items()]
    else:
        pairs = [(np.asarray(getattr(jw, part)),
                  getattr(tlayer[n], part).grad)
                 for jlayer, tlayer in zip(jg["layers"], lora["layers"])
                 for n, jw in jlayer.items() for part in ("a", "b")]
    for want, got in pairs:
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-4, err


def test_diffusion_mask():
    """The prompt is never masked, the noised ids are the mask id exactly
    where masked, t lies in [min_t, 1], and a generator seeded alike draws
    alike."""
    ids = torch.arange(1, 257).reshape(4, 64)
    pm = torch.zeros((4, 64), dtype=torch.bool)
    pm[:, :10] = True
    draws = [tdiff.diffusion_mask(torch.Generator().manual_seed(9), ids, MASK,
                                  prompt_mask=pm, min_t=0.2)
             for _ in range(2)]
    noised, masked, t = draws[0]
    assert not masked[:, :10].any() and masked.any()
    assert torch.equal(noised[masked], torch.full_like(noised[masked], MASK))
    assert torch.equal(noised[~masked], ids[~masked])
    assert bool(((t >= 0.2) & (t <= 1.0)).all())
    for a, b in zip(*draws):
        assert torch.equal(a, b)


def test_bidirectional_attention(pair):
    """causal=False lets position 0 see the last token: changing it moves
    position 0's logits (and with causal=True it does not)."""
    _, (tcfg, tparams) = pair
    ids = torch.arange(1, 17)[None]
    ids2 = ids.clone()
    ids2[0, -1] = 99
    for causal in (False, True):
        cfg = dataclasses.replace(tcfg, causal=causal)
        a, b = (tlogits_fn(tparams, None, x, cfg, remat=False)[0, 0]
                for x in (ids, ids2))
        assert (float((a - b).abs().max()) > 1e-6) == (not causal)


def test_diffusion_generate_matches_jax(pair):
    """Greedy iterative unmasking (temperature 0, f32) from an 8-token
    prompt over a 40-slot canvas in 8 steps gives JAX's token list
    exactly; the prompt is kept and no mask id is left."""
    (jcfg, jparams, jlora), (tcfg, tparams) = pair
    prompt = [5, 17, 33, 2, 90, 41, 7, 120]
    jm = JModel(cfg=jcfg, params=jparams, lora=jlora, max_seq_length=64)
    want = jdiff.diffusion_generate(jm, prompt, canvas_length=40, steps=8)
    tm = TModel(cfg=tcfg, params=tparams, lora=_torch_tree(jlora, False),
                max_seq_length=64)
    got = tdiff.diffusion_generate(tm, prompt, canvas_length=40, steps=8)
    assert got == want
    assert got[:8] == prompt and MASK not in got


def test_loader_matches_jax(tmp_path, monkeypatch):
    """A tiny ``llada`` checkpoint (llama keys, mask_token_id 120) loaded by
    both packages: bidirectional, the mask id from the config, equal f32
    logits; an autoregressive checkpoint raises RuntimeError; the mask id
    comes from the argument before the config, the tokenizer after it,
    then the last vocabulary id."""
    path = str(tmp_path / "llada")
    make_hf_checkpoint(path, dict(TINY_LLAMA, model_type="llada",
                                  mask_token_id=120))
    jm, _ = jdiff.FastDiffusionModel.from_pretrained(path, dtype="float32")
    tm, _ = tdiff.FastDiffusionModel.from_pretrained(path, dtype="float32",
                                                     device="cpu")
    assert tm.cfg.causal is False and tm.cfg.mask_token_id == 120
    assert tm.lora is None and not any(
        type(p).__name__ == "NF4Tensor" for p in tm.params["layers"][0].values())
    ids = np.arange(1, 25, dtype=np.int32)[None]
    want = np.asarray(jm.logits(jnp.asarray(ids), remat=False))
    got = tlogits_fn(tm.params, None, _t(ids).long(), tm.cfg, remat=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    ar = str(tmp_path / "ar")
    make_hf_checkpoint(ar, TINY_LLAMA)
    with pytest.raises(RuntimeError, match="autoregressive"):
        tdiff.FastDiffusionModel.from_pretrained(ar, device="cpu")

    assert tdiff.FastDiffusionModel.from_pretrained(
        path, dtype="float32", device="cpu",
        mask_token_id=7)[0].cfg.mask_token_id == 7
    cfg_path = os.path.join(path, "config.json")
    hf = json.load(open(cfg_path))
    del hf["mask_token_id"]
    json.dump(hf, open(cfg_path, "w"))

    class Tok:
        mask_token_id = 77

    monkeypatch.setattr(tloader, "load_tokenizer", lambda p: Tok())
    assert tdiff.FastDiffusionModel.from_pretrained(
        path, dtype="float32", device="cpu")[0].cfg.mask_token_id == 77
    monkeypatch.setattr(tloader, "load_tokenizer", lambda p: None)
    assert tdiff.FastDiffusionModel.from_pretrained(
        path, dtype="float32", device="cpu")[0].cfg.mask_token_id == \
        TINY_LLAMA["vocab_size"] - 1
    assert tdiff.is_diffusion_model_type(["llama", "dream"])
    assert not tdiff.is_diffusion_model_type("llama")


# ---------------------------------------------------------------------------
# trainer/diffusion.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full_ft", [False, True])
def test_diffusion_trainer_steps(pair, tmp_path, full_ft):
    """Two DiffusionTrainer steps (LoRA, and full fine-tuning with the head
    trained) equal a manual loop: the padded batches in order, one a step
    whatever ``gradient_accumulation_steps`` says, each step's mask drawn
    from one generator seeded from ``args.seed``, diffusion_loss and an
    optimizer step from build_optimizer; the logged losses and the
    trained tensors agree within 1e-6 relative. A model without a mask id
    is refused."""
    _, (tcfg, tparams) = pair
    rng = np.random.default_rng(4)
    ds = [{"input_ids": rng.integers(3, 240, n).tolist()}
          for n in (40, 25, 48, 33)]
    args = SFTConfig(output_dir=str(tmp_path), per_device_train_batch_size=2,
                     gradient_accumulation_steps=4, max_steps=2,
                     max_seq_length=S, learning_rate=1e-3, warmup_steps=0,
                     seed=11)

    def model():
        m = TModel(cfg=dataclasses.replace(tcfg),
                   params=copy.deepcopy(tparams), max_seq_length=S)
        if not full_ft:
            m.get_peft_model(r=4, lora_alpha=8,
                             use_gradient_checkpointing=False)
            for layer in m.lora["layers"]:
                for lw in layer.values():
                    lw.b.add_(0.01)
        return m

    trained = model()
    manual = copy.deepcopy(trained)
    with pytest.raises(ValueError, match="mask_token_id"):
        DiffusionTrainer(TModel(cfg=dataclasses.replace(
            tcfg, mask_token_id=None), params=tparams), train_dataset=ds,
            args=copy.deepcopy(args))
    tr = DiffusionTrainer(trained, train_dataset=ds, args=args)
    out = tr.train(resume_from_checkpoint=True)
    assert out.global_step == 2 and len(tr.step_times) == 2

    batches = DiffusionTrainer(manual, train_dataset=ds,
                               args=copy.deepcopy(args)).prepare_batches()
    assert len(batches) == 2 and all(
        b.input_ids.shape == (2, S) for b in batches)
    trainables = manual.params if full_ft else manual.lora
    tx, _ = build_optimizer(args, 2, trainables)
    for p in tx.params:
        p.requires_grad_(True)
    gen = torch.Generator().manual_seed(args.seed)
    losses = []
    for pb in batches:
        batch = {k: _t(getattr(pb, k)) for k in ("input_ids", "segment_ids",
                                                 "positions")}
        loss = tdiff.diffusion_loss(manual.params, manual.lora, batch,
                                    manual.cfg, gen, remat=manual.gc_mode)
        loss.backward()
        tx.step()
        tx.zero_grad()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose([e["loss"] for e in tr.state_log], losses,
                               rtol=1e-6)
    assert [e["step"] for e in tr.state_log] == [1, 2]
    got = named_leaves(trained.params if full_ft else trained.lora)
    want = named_leaves(trainables)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
