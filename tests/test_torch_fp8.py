"""The FP8 slice of the PyTorch port against the JAX package, on the CPU:
block quantization byte for byte, dequantization, the checkpoint wrapper,
the plain versions of K12/K13 against the Pallas kernels in interpret
mode, fp8_matmul's autograd against jax.grad, lora_matmul over an FP8
base, a 2-layer Llama whose seven projections are FP8 (loss, every LoRA
gradient, greedy ids), tree_bytes, the merged save that neither package
has, interop and the dispatch to the kernel wrappers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsloth_tpu.models import decoder as jdec
from unsloth_tpu.models.config import ModelConfig as JConfig
from unsloth_tpu.models.config import RopeScaling as JRope
from unsloth_tpu.models.loader import LanguageModel as JModel
from unsloth_tpu.models.params import init_lora_tree, init_params
from unsloth_tpu.ops import fp8 as jfp8
from unsloth_tpu.ops import fp8_matmul as jfm
from unsloth_tpu.ops import lora as jlora_ops
from unsloth_tpu.ops.lora import LoRAWeights as JLoRA
from unsloth_tpu_torch import interop
from unsloth_tpu_torch.interop import lora_from_numpy, params_from_numpy
from unsloth_tpu_torch.models import decoder as tdec
from unsloth_tpu_torch.models.config import ModelConfig as TConfig
from unsloth_tpu_torch.models.config import RopeScaling as TRope
from unsloth_tpu_torch.models.loader import LanguageModel as TModel
from unsloth_tpu_torch.ops import fp8 as tfp8
from unsloth_tpu_torch.ops import lora as tlora_ops
from unsloth_tpu_torch.ops.fp8_matmul import (fp8_matmul, fp8_matmul_dx,
                                              fp8_matmul_dx_ref,
                                              fp8_matmul_fwd)

QUANT_SHAPES = [((256, 384), 128), ((100, 200), 128), ((64, 96), 32)]
PROJECTIONS = ("q", "k", "v", "o", "gate", "up", "down")


def _weight(shape, seed):
    """A weight whose rows differ in scale by two orders of magnitude, so
    that the blocks' scales differ."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * rng.uniform(0.01, 1.0, (shape[0], 1))).astype(np.float32)


def _pair(shape, block, seed=0, dtype=jnp.float32):
    w = _weight(shape, seed)
    return (jfp8.quantize_fp8_block(jnp.asarray(w), block=block, dtype=dtype),
            tfp8.quantize_fp8_block(torch.from_numpy(w), block=block,
                                    dtype=torch.float32))


def _bytes(values):
    if isinstance(values, torch.Tensor):
        return values.view(torch.uint8).numpy()
    return np.asarray(values).view(np.uint8)


@pytest.mark.parametrize("shape,block", QUANT_SHAPES)
def test_quantize_bytes_equal_jax(shape, block):
    """Both round fp32 / scale to e4m3 to nearest even: the same bytes (no
    value comes near torch's NaN above 464: |scaled| <= 448 up to one fp32
    rounding) and the same fp32 scales."""
    jq, tq = _pair(shape, block)
    assert tq.values.dtype == torch.float8_e4m3fn
    assert tuple(tq.values.shape) == shape and tq.shape == shape
    assert tq.scales.shape == (-(-shape[0] // block), -(-shape[1] // block))
    np.testing.assert_array_equal(_bytes(tq.values), _bytes(jq.values))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert tq.nbytes == jq.nbytes


@pytest.mark.parametrize("shape,block", QUANT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_equal_jax(shape, block, dtype):
    """fp32(value) * scale, rounded once: equal in fp32 and in bf16."""
    jq, tq = _pair(shape, block)
    want = jfp8.dequantize_fp8(jq, getattr(jnp, dtype)).astype(jnp.float32)
    got = tfp8.dequantize_fp8(tq, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))


def test_checkpoint_tensor_round_trips():
    """A (weight fp8, weight_scale_inv) pair wraps without changing a byte
    and dequantizes as the quantized tensor does (test_ops_fp8.py's
    checkpoint check)."""
    _, tq = _pair((256, 256), 128, seed=3)
    q2 = tfp8.load_fp8_checkpoint_tensor(tq.values, tq.scales)
    np.testing.assert_array_equal(_bytes(q2.values), _bytes(tq.values))
    np.testing.assert_array_equal(
        tfp8.dequantize_fp8(q2, torch.float32).numpy(),
        tfp8.dequantize_fp8(tq, torch.float32).numpy())
    assert q2.block == 128 and q2.dtype == torch.bfloat16


#: the plain versions against the Pallas kernels (interpret mode): fp32
#: within 1e-5 of max|y| (fp32 sums in other orders), bf16 within 2^-7 of
#: max|y| (the same bf16 weights and fp32 sums, one bf16 rounding of the
#: output: one ulp apart at most)
PLAIN_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_pallas_kernels(dtype):
    jq, tq = _pair((256, 384), 128, seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((50, 384)).astype(np.float32)
    g = rng.standard_normal((50, 256)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jg = jnp.asarray(g).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    for got, want in (
            (tfp8.fp8_matmul_ref(tx, tq), jfm._fwd_pallas(jx, jq,
                                                          interpret=True)),
            (fp8_matmul_dx_ref(tg, tq), jfm._bwd_pallas(jg, jq,
                                                            interpret=True))):
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == getattr(torch, dtype)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= PLAIN_TOL[dtype] * np.abs(want).max(), err


def test_fp8_matmul_autograd_matches_jax_grad():
    """y and dx of fp8_matmul through autograd against JAX's fp8_matmul
    (K12 forward, K13 in its custom VJP, interpret mode off the TPU) under
    jax.grad, fp32, within 1e-5 of the largest value; the frozen FP8 base
    gets no gradient."""
    jq, tq = _pair((384, 256), 128, seed=4)
    x = np.random.default_rng(5).standard_normal((2, 30, 256)).astype(
        np.float32)

    def jloss(x_):
        return jnp.sum(jnp.sin(jfm.fp8_matmul(x_, jq)))

    want_y = np.asarray(jfm.fp8_matmul(jnp.asarray(x), jq))
    want_dx = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = fp8_matmul(tx, tq)
    torch.sin(y).sum().backward()
    for got, want in ((y.detach().numpy(), want_y),
                      (tx.grad.numpy(), want_dx)):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert not tq.values.requires_grad and tq.values.grad is None
    assert not tq.scales.requires_grad and tq.scales.grad is None


@pytest.mark.parametrize("block", [128, 32])
def test_lora_matmul_over_fp8_matches_jax(block):
    """y, dx, dA and dB of lora_matmul over an FP8 base against jax.vjp of
    JAX's, fp32, within 1e-5 of each tensor's largest value."""
    jq, tq = _pair((200, 160), block, seed=6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 11, 160)).astype(np.float32)
    a = (rng.standard_normal((8, 160)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((200, 8)) * 0.1).astype(np.float32)
    gy = rng.standard_normal((3, 11, 200)).astype(np.float32)

    def jf(x_, a_, b_):
        return jlora_ops.lora_matmul(x_, jq, JLoRA(a=a_, b=b_, scale=2.0))

    want_y, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    wants = (want_y,) + vjp(jnp.asarray(gy))
    tx, ta, tb = (torch.from_numpy(v).requires_grad_(True) for v in (x, a, b))
    y = tlora_ops.lora_matmul(tx, tq, tlora_ops.LoRAWeights(a=ta, b=tb,
                                                            scale=2.0))
    y.backward(torch.from_numpy(gy))
    for got, want in zip((y.detach(), tx.grad, ta.grad, tb.grad), wants):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# a 2-layer Llama with every projection in FP8
# ---------------------------------------------------------------------------

CFG = dict(model_type="llama", vocab_size=256, hidden_size=128,
           intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
           max_position_embeddings=256, rms_norm_eps=1e-5)
LLAMA3 = dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
              high_freq_factor=4.0, original_max_position_embeddings=32)


def _fp8_models(block):
    """(JAX model, LoRA), (port model, LoRA): random fp32 weights with each
    of the seven projections quantized by quantize_fp8_block in JAX (as
    test_ops_fp8.py's training test does) and carried byte for byte; LoRA
    r=4 with a nonzero B."""
    jcfg = JConfig(**CFG, rope_scaling=JRope(**LLAMA3))
    tcfg = TConfig(**CFG, rope_scaling=TRope(**LLAMA3))
    jp = init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32,
                     init_scale=0.1)
    for layer in jp["layers"]:
        for name in PROJECTIONS:
            layer[name] = jfp8.quantize_fp8_block(layer[name], block=block,
                                                  dtype=jnp.float32)
    jl = init_lora_tree(jcfg, jax.random.PRNGKey(1), r=4, alpha=8.0)
    rng = np.random.default_rng(8)
    for layer in jl["layers"]:
        for name, lw in list(layer.items()):
            b = rng.standard_normal(lw.b.shape).astype(np.float32) * 0.05
            layer[name] = JLoRA(lw.a, jnp.asarray(b), lw.scale)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tl = lora_from_numpy(jax.tree_util.tree_map(np.asarray, jl), "cpu")
    return ((JModel(cfg=jcfg, params=jp), jl),
            (TModel(cfg=tcfg, params=tp), tl))


@pytest.fixture(scope="module", params=[128, 32], ids=["block128",
                                                       "block32"])
def fp8_models(request):
    return _fp8_models(request.param)


def _padded_batch():
    """Two rows of 48 tokens, the second with a pad tail of 17."""
    rng = np.random.default_rng(9)
    ids = rng.integers(3, 250, (2, 48)).astype(np.int32)
    seg = np.ones((2, 48), np.int32)
    ids[1, 31:] = 0
    seg[1, 31:] = 0
    labels = np.where(seg == 1, ids, -100).astype(np.int32)
    return {"input_ids": ids, "labels": labels, "segment_ids": seg}


def test_two_layer_fp8_llama_loss_and_grads_match_jax(fp8_models):
    """loss_fn over the FP8 base on a padded batch, and d loss / d every
    LoRA leaf, against JAX's loss_fn under jax.grad: fp32, loss within 1e-4
    relative, each leaf within 1e-4 relative L2."""
    (jm, jl), (tm, tl) = fp8_models
    batch = _padded_batch()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda lo, p, b: jdec.loss_fn(p, lo, b, jm.cfg, remat=False)))(
        jl, jm.params, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [t for layer in tl["layers"] for lw in layer.values()
              for t in (lw.a, lw.b)]
    for t in leaves:
        t.requires_grad_(True)
    loss = tdec.loss_fn(tm.params, tl,
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        tm.cfg, remat=False)
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    for jlayer, tlayer in zip(jgrads["layers"], tl["layers"]):
        assert sorted(jlayer) == sorted(PROJECTIONS)
        for name, jw in jlayer.items():
            for part in ("a", "b"):
                want = np.asarray(getattr(jw, part))
                got = getattr(tlayer[name], part).grad.numpy()
                rel = np.linalg.norm(got - want) / np.linalg.norm(want)
                assert rel <= 1e-4, (name, part, rel)
    for t in leaves:
        t.grad = None
        t.requires_grad_(False)


def test_two_layer_fp8_llama_greedy_ids_match_jax(fp8_models):
    """8 greedy decode steps over the FP8 base with the LoRA on, fp32: the
    same ids."""
    (jm, jl), (tm, tl) = fp8_models
    jm.lora, tm.lora = jl, tl
    prompts = [[5, 6, 7, 8, 9, 10, 11], [3] * 20 + [4, 5]]
    want = jm.generate(prompts, max_new_tokens=8, temperature=0.0,
                       return_token_ids=True)
    got = tm.generate(prompts, max_new_tokens=8, temperature=0.0,
                      return_token_ids=True)
    assert got == want
    assert all(len(r) == 8 for r in got)


def test_tree_bytes_counts_fp8_as_jax_leaves(fp8_models):
    """tree_bytes (the fused-CE gate's weight bytes) of a tree with FP8
    projections: values plus scales, JAX's sum over the tree's leaves."""
    (jm, _), (tm, _) = fp8_models
    want = sum(x.size * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(jm.params)
               if hasattr(x, "dtype"))
    assert tdec.tree_bytes(tm.params) == want
    fp8 = sum(layer[n].nbytes for layer in tm.params["layers"]
              for n in PROJECTIONS)
    dense = sum(tdec.tree_bytes(v) for k, v in tm.params.items()
                if k != "layers")
    assert fp8 > 0 and tdec.tree_bytes(tm.params) > dense + fp8 - 1


def test_merged_save_over_fp8_raises_in_both_packages(fp8_models, tmp_path):
    """JAX's merge_lora has no FP8 branch (AttributeError on
    FP8Tensor.astype); the port raises NotImplementedError instead of
    inventing a merge, and save_pretrained_merged raises before writing a
    file. If either side changes, this fails."""
    (jm, jl), (tm, tl) = fp8_models
    with pytest.raises(AttributeError, match="astype"):
        jlora_ops.merge_lora(jm.params["layers"][0]["q"],
                             jl["layers"][0]["q"])
    with pytest.raises(NotImplementedError, match="FP8"):
        tlora_ops.merge_lora(tm.params["layers"][0]["q"],
                             tl["layers"][0]["q"])
    tm.lora = tl
    out = tmp_path / "merged"
    with pytest.raises(NotImplementedError, match="FP8"):
        tm.save_pretrained_merged(str(out))
    assert not out.exists() or not any(out.iterdir())


def test_adapter_round_trip_over_fp8(fp8_models, tmp_path):
    """save_lora / load_lora work unchanged over an FP8 base: the reloaded
    adapter gives the same loss."""
    _, (tm, tl) = fp8_models
    tm.lora, tm.lora_config = tl, {"r": 4, "lora_alpha": 8.0}
    batch = {k: torch.from_numpy(v) for k, v in _padded_batch().items()}
    with torch.no_grad():
        before = float(tdec.loss_fn(tm.params, tm.lora, batch, tm.cfg,
                                    remat=False))
        tm.save_lora(str(tmp_path / "lora"))
        tm.lora = None
        tm.load_lora(str(tmp_path / "lora"))
        after = float(tdec.loss_fn(tm.params, tm.lora, batch, tm.cfg,
                                   remat=False))
    assert before == after


def test_interop_carries_fp8_byte_for_byte():
    """An FP8 tree goes across with its values' bytes and scales unchanged,
    ``dtype=`` sets only the dequant dtype, and _to_numpy gives the bytes
    back."""
    jq, _ = _pair((100, 200), 32, seed=10)
    tree = {"layers": [{"q": jq, "input_norm": jnp.ones((4,))}]}
    got = params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu",
                            dtype=torch.bfloat16)
    tq = got["layers"][0]["q"]
    assert isinstance(tq, tfp8.FP8Tensor)
    assert tq.values.dtype == torch.float8_e4m3fn
    assert tq.scales.dtype == torch.float32
    assert tq.dtype == torch.bfloat16 and tq.block == 32
    assert tq.shape == (100, 200)
    assert got["layers"][0]["input_norm"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bytes(tq.values), _bytes(jq.values))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(interop._to_numpy(tq.values),
                                  _bytes(jq.values))


def test_off_cpu_tensors_reach_the_kernel_wrappers():
    """A tensor off the CPU (meta, standing in for CUDA) goes to the kernel
    wrappers, never to the plain versions: base_matmul and the dx wrapper
    raise for want of a kernel on that device, and the wrappers refuse
    fp32 on any device but the CPU."""
    q = tfp8.FP8Tensor(
        values=torch.empty((64, 96), dtype=torch.float8_e4m3fn,
                           device="meta"),
        scales=torch.empty((2, 3), device="meta"), shape=(64, 96), block=32)
    x = torch.empty((5, 96), dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        tlora_ops.base_matmul(x, q)
    with pytest.raises(NotImplementedError, match="meta"):
        fp8_matmul_dx(torch.empty((5, 64), dtype=torch.bfloat16,
                                      device="meta"), q)
    before = (fp8_matmul_fwd.launches, fp8_matmul_dx.launches)
    _, tq = _pair((64, 96), 32)
    fp8_matmul(torch.ones((2, 96), requires_grad=True), tq).sum(
        ).backward()
    assert (fp8_matmul_fwd.launches, fp8_matmul_dx.launches) == before
