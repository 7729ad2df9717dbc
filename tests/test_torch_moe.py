"""The MoE ops of the PyTorch port against the JAX package on the same numpy
inputs, on the CPU: stacked-NF4 quantization byte for byte, the plain twin
of the grouped NF4 kernels (K14 forward with its bias epilogue, K15 dx)
against the JAX Pallas kernels in interpret mode, the four routings, and
the grouped MoE MLP (values and input gradients) against JAX's grouped
implementation (megablox ``gmm`` in interpret mode) and its dense oracle,
with NF4 experts (K14/K15's plain twin) and with dense ones (K19's plain
version, ``ops/gmm.py``), and the dispatch of dense experts off the CPU.

Tolerance, unless a test says otherwise: 1e-5 relative plus 1e-5 absolute
in fp32 (the same fp32 products summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsloth_tpu.ops import moe as jmoe
from unsloth_tpu.ops import nf4 as jnf4
from unsloth_tpu.ops import nf4_gmm as jgmm
from unsloth_tpu_torch.interop import params_from_numpy
from unsloth_tpu_torch.ops import moe as tmoe
from unsloth_tpu_torch.ops import nf4 as tnf4
from unsloth_tpu_torch.ops.nf4_gmm import (nf4_gmm, nf4_gmm_dx, nf4_gmm_ref,
                                           use_nf4_gmm)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _stack(e, n, k, seed):
    return (np.random.default_rng(seed).standard_normal((e, n, k))
            * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) NF4Stacked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs", [32, 64])
def test_quantize_nf4_stacked_bytes_equal_jax(bs):
    """Packed bytes and fp32 absmax equal JAX's exactly, and the
    dequantized stacks too; gpt-oss's in = 2,880 pattern (in/2 a multiple
    of 32, not of 64) at bs 32."""
    k = 192 if bs == 32 else 256
    w = _stack(3, 40, k, seed=bs)
    jq = jnf4.quantize_nf4_stacked(jnp.asarray(w), block_size=bs,
                                   dtype=jnp.float32)
    tq = tnf4.quantize_nf4_stacked(_t(w), block_size=bs,
                                   dtype=torch.float32)
    assert tq.shape == tuple(jq.shape) and tq.block_size == bs
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
    np.testing.assert_array_equal(tq.absmax.reshape(-1).numpy(),
                                  np.asarray(jq.absmax).reshape(-1))
    np.testing.assert_array_equal(
        tnf4.dequantize_nf4_stacked(tq, torch.float32).numpy(),
        np.asarray(jnf4.dequantize_nf4_stacked(jq, jnp.float32)))
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), "cpu")
    assert isinstance(carried, tnf4.NF4Stacked)
    np.testing.assert_array_equal(carried.packed.numpy(), tq.packed.numpy())
    assert use_nf4_gmm(tq)


# ---------------------------------------------------------------------------
# (b) K14 / K15: the plain twin against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

#: id -> (experts, N, K, block size, group sizes): empty groups included,
#: a K whose half is not a multiple of 64 (gpt-oss's pattern)
GMM_CASES = {
    "bs64-empty": (4, 128, 256, 64, [0, 17, 0, 23]),
    "bs32-gptoss-pattern": (3, 96, 192, 32, [11, 0, 29]),
}


@pytest.fixture(scope="module", params=list(GMM_CASES))
def gmm_case(request):
    e, n, k, bs, sizes = GMM_CASES[request.param]
    rng = np.random.default_rng(e + n)
    w = _stack(e, n, k, seed=n)
    m = sum(sizes)
    x = rng.standard_normal((m, k)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    bias = rng.standard_normal((e, n)).astype(np.float32)
    jq = jnf4.quantize_nf4_stacked(jnp.asarray(w), block_size=bs,
                                   dtype=jnp.float32)
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), "cpu")
    return jq, tq, x, g, bias, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("with_bias", [False, True])
def test_nf4_gmm_plain_forward_matches_pallas(gmm_case, with_bias):
    jq, tq, x, _, bias, sizes = gmm_case
    want = jgmm._nf4_gmm_fwd_impl(
        jnp.asarray(x), jq, jnp.asarray(sizes),
        bias=jnp.asarray(bias) if with_bias else None, interpret=True)
    got = nf4_gmm(_t(x), tq, _t(sizes),
                  bias=_t(bias) if with_bias else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the plain version itself, as JAX's oracle computes it
    ref = jgmm.nf4_gmm_ref(jnp.asarray(x), jq, jnp.asarray(sizes))
    np.testing.assert_allclose(nf4_gmm_ref(_t(x), tq, _t(sizes)).numpy(),
                               np.asarray(ref), **TOL)


def test_nf4_gmm_plain_dx_matches_pallas(gmm_case):
    jq, tq, x, g, _, sizes = gmm_case
    want = jgmm._nf4_gmm_bwd_impl(jnp.asarray(g), jq, jnp.asarray(sizes),
                                  interpret=True)
    np.testing.assert_allclose(nf4_gmm_dx(_t(g), tq, _t(sizes)).numpy(),
                               np.asarray(want), **TOL)
    # the autograd backward of nf4_gmm is the dx twin; no grad to the bias
    xt = _t(x).requires_grad_(True)
    bt = _t(gmm_case[4]).requires_grad_(True)
    y = nf4_gmm(xt, tq, _t(sizes), bias=bt)
    y.backward(_t(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)
    assert bt.grad is None


# ---------------------------------------------------------------------------
# (c) routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("routing,norm", [("softmax_topk", True),
                                          ("softmax_topk", False),
                                          ("topk_softmax", False),
                                          ("llama4", False),
                                          ("deepseek", True)])
def test_route_matches_jax(routing, norm):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((37, 8)).astype(np.float32)
    params = None
    if routing == "deepseek":
        corr = (rng.standard_normal(8) * 0.1).astype(np.float32)
        params = dict(n_group=4, topk_group=2, routed_scaling=2.5)
        jp = dict(params, correction_bias=jnp.asarray(corr))
        tp = dict(params, correction_bias=_t(corr))
    else:
        jp = tp = None
    jw, js = jmoe._route(jnp.asarray(logits), 3, norm, routing, jp)
    tw, ts = tmoe._route(_t(logits), 3, norm, routing, tp)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)


# ---------------------------------------------------------------------------
# (d) the MoE MLP
# ---------------------------------------------------------------------------

def _experts(e, f, d, seed, bias):
    rng = np.random.default_rng(seed)
    ex = {"gate": _stack(e, f, d, seed), "up": _stack(e, f, d, seed + 1),
          "down": _stack(e, d, f, seed + 2)}
    if bias:
        ex["gate_bias"] = (rng.standard_normal((e, f)) * 0.1).astype(np.float32)
        ex["up_bias"] = (rng.standard_normal((e, f)) * 0.1).astype(np.float32)
        ex["down_bias"] = (rng.standard_normal((e, d)) * 0.1).astype(np.float32)
    return ex


#: id -> (activation, expert biases, NF4 experts): gpt-oss's (clamped GLU,
#: biases, NF4 at block 32 for in = 96) and a qwen3-moe-like (SwiGLU), each
#: also with dense experts, which JAX runs through megablox gmm (F = 96 and
#: D = 64 are not multiples of 128: its route pads them)
MLP_CASES = {
    "gpt-oss-nf4": ("gpt_oss_glu", True, True),
    "swiglu-nf4": ("silu", False, True),
    "gpt-oss-dense": ("gpt_oss_glu", True, False),
    "swiglu-dense": ("silu", False, False),
}


@pytest.fixture(scope="module", params=list(MLP_CASES))
def mlp_case(request):
    act, bias, nf4 = MLP_CASES[request.param]
    e, f, d, n, k = 4, 96, 64, 29, 2
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, d)).astype(np.float32)
    logits = rng.standard_normal((n, e)).astype(np.float32)
    cot = rng.standard_normal((n, d)).astype(np.float32)
    ex = {kk: jnp.asarray(v) for kk, v in _experts(e, f, d, 5, bias).items()}
    if nf4:
        for name in ("gate", "up", "down"):
            w = ex[name]
            bs = 64 if (w.shape[-1] // 2) % 64 == 0 else 32
            ex[name] = jnf4.quantize_nf4_stacked(w, block_size=bs,
                                                 dtype=jnp.float32)
    tex = params_from_numpy(jax.tree_util.tree_map(np.asarray, ex), "cpu")
    return act, ex, tex, x, logits, cot, k


def _jax_out_and_grad(fn, x, logits, cot):
    def loss(x_):
        return jnp.sum(fn(x_, jnp.asarray(logits)) * jnp.asarray(cot))

    out = fn(jnp.asarray(x), jnp.asarray(logits))
    return np.asarray(out), np.asarray(jax.grad(loss)(jnp.asarray(x)))


def _torch_out_and_grad(fn, x, logits, cot):
    xt = _t(x).requires_grad_(True)
    out = fn(xt, _t(logits))
    out.backward(_t(cot))
    return out.detach().numpy(), xt.grad.numpy()


def test_moe_grouped_matches_jax_grouped_and_dense(mlp_case):
    act, ex, tex, x, logits, cot, k = mlp_case
    jgrouped = _jax_out_and_grad(
        lambda x_, l_: jmoe.moe_mlp_grouped(x_, l_, ex, k, act, True,
                                            interpret=True), x, logits, cot)
    jdense = _jax_out_and_grad(
        lambda x_, l_: jmoe.moe_mlp_dense(x_, l_, ex, k, act, True),
        x, logits, cot)
    got = _torch_out_and_grad(
        lambda x_, l_: tmoe.moe_mlp(x_, l_, tex, k, act, True), x, logits,
        cot)
    for want in (jgrouped, jdense):
        np.testing.assert_allclose(got[0], want[0], **TOL)
        np.testing.assert_allclose(got[1], want[1], **TOL)


@pytest.mark.parametrize("impl", ["dense", "eloop"])
def test_moe_oracles_match_jax(mlp_case, impl):
    act, ex, tex, x, logits, cot, k = mlp_case
    jfn = {"dense": jmoe.moe_mlp_dense,
           "eloop": jmoe.moe_mlp_expert_loop}[impl]
    want = _jax_out_and_grad(lambda x_, l_: jfn(x_, l_, ex, k, act, True),
                             x, logits, cot)
    got = _torch_out_and_grad(
        lambda x_, l_: tmoe.moe_mlp(x_, l_, tex, k, act, True, impl=impl),
        x, logits, cot)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)


def test_gpt_oss_glu_matches_jax():
    from unsloth_tpu.ops.activations import gpt_oss_glu as jglu
    from unsloth_tpu_torch.ops.activations import gpt_oss_glu as tglu

    rng = np.random.default_rng(2)
    e = (rng.standard_normal((64, 32)) * 6).astype(np.float32)
    g = (rng.standard_normal((64, 32)) * 6).astype(np.float32)
    np.testing.assert_allclose(tglu(_t(e), _t(g)).numpy(),
                               np.asarray(jglu(jnp.asarray(e),
                                               jnp.asarray(g))), **TOL)


def test_dense_experts_raise_on_device(monkeypatch):
    """Dense experts off the CPU (a meta tensor stands in for a CUDA one)
    take the grouped route to K19's wrapper, which raises for a device
    without a kernel, and never reach the plain version gmm_ref."""
    from unsloth_tpu_torch.ops import gmm as tgmm

    def no_plain(*a, **kw):
        raise AssertionError("gmm_ref ran on a tensor off the CPU")

    monkeypatch.setattr(tgmm, "gmm_ref", no_plain)
    reached = []
    real_fwd = tgmm.gmm_fwd

    def fwd(*a, **kw):
        reached.append(a[0].device.type)
        return real_fwd(*a, **kw)

    monkeypatch.setattr(tgmm, "gmm_fwd", fwd)
    e, f, d = 2, 96, 64
    experts = {"gate": torch.empty((e, f, d), device="meta"),
               "up": torch.empty((e, f, d), device="meta"),
               "down": torch.empty((e, d, f), device="meta")}
    x = torch.empty((4, d), device="meta")
    logits = torch.empty((4, e), device="meta")
    with pytest.raises(NotImplementedError, match="no kernel for device meta"):
        tmoe.moe_mlp(x, logits, experts, 1, "silu", True)
    assert reached == ["meta"]
