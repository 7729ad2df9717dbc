"""LayerNorm of the PyTorch port (its CPU path: the plain versions of the
K5/K6 kernels) against the JAX package's Pallas kernels ``_ln_fwd_pallas``
and ``_ln_bwd_pallas`` in interpret mode (as tests/test_ops_norms.py runs
them on the CPU), and the port's autograd Function against ``jax.vjp`` of
the JAX reference: fp32, bf16 and ``b=None``.

Tolerances. fp32: both sides compute the same formula in fp32 with sums
in another order, so outputs agree to 1e-5 of the tensor's largest value
(the statistics of 384 values carry ~1e-7 relative error; dx's three terms
cancel, so its bound is taken against max|dx| too). bf16: both round the
same fp32 value, which they compute with ~1e-7 relative error, so each
element is within one bf16 ulp of the other's (plus 2^-20 of the largest
value, the fp32 error of terms that cancel to near zero).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsloth_tpu.ops.rms_norm import _ln_bwd_pallas, _ln_fwd_pallas
from unsloth_tpu.ops.rms_norm import layer_norm_ref as jax_layer_norm_ref
from unsloth_tpu_torch.interop import to_tensor
from unsloth_tpu_torch.ops.rms_norm import (layer_norm, layer_norm_bwd,
                                            layer_norm_bwd_ref,
                                            layer_norm_fwd, layer_norm_ref)

EPS = 1e-5
D = 384


def _inputs(dtype, seed=0, d=D):
    """x [2, 7, d] with a per-row offset and scale, w near 1, b small, g:
    numpy from a seed, as JAX arrays of ``dtype`` and the port's tensors of
    the same values."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 7, d)) * rng.uniform(0.5, 3.0, (2, 7, 1))
         + rng.standard_normal((2, 7, 1))).astype(np.float32)
    w = (1.0 + 0.2 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    g = rng.standard_normal((2, 7, d)).astype(np.float32)
    js = [jnp.asarray(a).astype(dtype) for a in (x, w, b, g)]
    ts = [to_tensor(np.asarray(a), "cpu") for a in js]
    return js, ts


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
        assert np.all(np.abs(got - want) <= ulp + 2.0 ** -20 * scale)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_fwd_matches_jax_kernel(dtype, bias):
    (xj, wj, bj, _), (xt, wt, bt, _) = _inputs(getattr(jnp, dtype))
    if not bias:   # b=None is zeros, as the JAX dispatch makes it
        bj, bt = jnp.zeros_like(wj), None
    kernel = _ln_fwd_pallas(xj, wj, bj, EPS)
    out = layer_norm(xt, wt, bt, EPS)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    _close(out, kernel, dtype)
    _close(out, jax_layer_norm_ref(xj, wj, bj, EPS), dtype)
    np.testing.assert_array_equal(_np(layer_norm_fwd(xt, wt, bt, EPS)),
                                  _np(layer_norm_ref(xt, wt, bt, EPS)))


def _ln_bwd_against_pallas(dtype, seed, d=D):
    (xj, wj, _, gj), (xt, wt, _, gt) = _inputs(getattr(jnp, dtype), seed, d)
    jdx, jdw, jdb = _ln_bwd_pallas(xj, wj, gj, EPS)
    dx, dw, db = layer_norm_bwd(xt, wt, gt, EPS)
    assert dx.dtype == xt.dtype and dw.dtype == db.dtype == torch.float32
    _close(dx, jdx, dtype)
    # dW and dB: fp32 sums over 14 rows of the same products
    for got, want in ((dw, jdw), (db, jdb)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=1e-5 * np.abs(_np(want)).max())
    for got, want in zip((dx, dw, db), layer_norm_bwd_ref(xt, wt, gt, EPS)):
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_bwd_matches_jax_kernel(dtype):
    _ln_bwd_against_pallas(dtype, 1)


def test_layer_norm_bwd_matches_jax_kernel_at_whisper_width():
    """The same at Whisper-large-v3's d_model, 1,280 (160 chunks of bf16:
    K6's lanes hold one or two), in bf16."""
    _ln_bwd_against_pallas("bfloat16", 4, d=1280)


@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_grads_match_jax_vjp(bias):
    """The autograd Function (saves x and w, K6's formula in the backward)
    against jax.vjp of the JAX reference, fp32: dx, dW and dB (None for
    b=None) in the parameters' dtypes."""
    (xj, wj, bj, gj), (xt, wt, bt, gt) = _inputs(jnp.float32, seed=2)
    if not bias:
        bj, bt = jnp.zeros_like(wj), None
    _, vjp = jax.vjp(lambda x_, w_, b_: jax_layer_norm_ref(x_, w_, b_, EPS),
                     xj, wj, bj)
    rdx, rdw, rdb = vjp(gj)
    leaves = [t.clone().requires_grad_(True) for t in (xt, wt)]
    bl = None if bt is None else bt.clone().requires_grad_(True)
    layer_norm(*leaves, bl, EPS).backward(gt)
    for got, want in ((leaves[0].grad, rdx), (leaves[1].grad, rdw)) + (
            ((bl.grad, rdb),) if bias else ()):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=1e-5 * np.abs(_np(want)).max())


def test_layer_norm_frozen_weights_give_dx_only():
    """x trainable, w and b frozen (the Whisper LoRA path): only x gets a
    gradient; without any trainable input no graph is built."""
    _, (xt, wt, bt, gt) = _inputs(jnp.bfloat16, seed=3)
    x = xt.clone().requires_grad_(True)
    layer_norm(x, wt, bt, EPS).backward(gt)
    np.testing.assert_array_equal(
        x.grad.float().numpy(),
        layer_norm_bwd_ref(xt, wt, gt, EPS)[0].float().numpy())
    assert wt.grad is None and bt.grad is None
    assert layer_norm(xt, wt, bt, EPS).grad_fn is None


@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_frozen_weights_skip_the_weight_gradients(bias,
                                                            monkeypatch):
    """w and b frozen (the Whisper LoRA path): the autograd Function asks
    layer_norm_bwd for neither dW nor dB (K6's dx-only form on the card),
    whose dx equals the full form's bit for bit and jax.vjp's (fp32), and
    which returns None for both."""
    (xj, wj, bj, gj), (xt, wt, bt, gt) = _inputs(jnp.float32, seed=5)
    if not bias:
        bj, bt = jnp.zeros_like(wj), None
    _, vjp = jax.vjp(lambda x_: jax_layer_norm_ref(x_, wj, bj, EPS), xj)
    (rdx,) = vjp(gj)
    tln = importlib.import_module("unsloth_tpu_torch.ops.rms_norm")
    asked = []

    def spy(*args, **kw):
        asked.append(kw.get("need_dw", True))
        return layer_norm_bwd(*args, **kw)

    monkeypatch.setattr(tln, "layer_norm_bwd", spy)
    x = xt.clone().requires_grad_(True)
    layer_norm(x, wt, bt, EPS).backward(gt)
    assert asked == [False]
    dx, dw, db = layer_norm_bwd(xt, wt, gt, EPS, need_dw=False)
    assert dw is None and db is None
    assert torch.equal(dx, layer_norm_bwd(xt, wt, gt, EPS)[0])
    assert torch.equal(x.grad, dx)
    np.testing.assert_allclose(_np(x.grad), _np(rdx), rtol=0,
                               atol=1e-5 * np.abs(_np(rdx)).max())


def test_launch_counters_stay_zero_on_cpu():
    _, (xt, wt, bt, gt) = _inputs(jnp.float32)
    layer_norm_fwd(xt, wt, bt, EPS)
    layer_norm_bwd(xt, wt, gt, EPS)
    assert layer_norm_fwd.launches == 0 and layer_norm_bwd.launches == 0


def test_layer_norm_dispatch_never_falls_back():
    """A tensor off the CPU reaches the kernel wrappers' checks, never the
    plain versions (a meta tensor stands in for the card here)."""
    x = torch.empty((4, D), device="meta")
    w = torch.empty((D,), device="meta")
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        layer_norm(x, w, None, EPS)
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        layer_norm_bwd(x, w, x, EPS)
