"""RMSNorm of the PyTorch port (its CPU path, the kernel's plain version)
against the JAX package's Pallas kernel in interpret mode and its jnp
reference: gemma on and off, f32 and bf16."""

import jax.numpy as jnp
import numpy as np
import pytest

from unsloth_tpu.ops.rms_norm import _rms_norm_fwd_pallas
from unsloth_tpu.ops.rms_norm import rms_norm_ref as jax_rms_norm_ref
from unsloth_tpu_torch.interop import to_tensor
from unsloth_tpu_torch.ops.rms_norm import rms_norm, rms_norm_ref

EPS = 1e-5


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 5, 256)) * 3.0).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    wj = jnp.asarray(w).astype(dtype)
    return xj, wj, to_tensor(np.asarray(xj), "cpu"), to_tensor(np.asarray(wj), "cpu")


@pytest.mark.parametrize("gemma", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax_kernel_and_ref(dtype, gemma):
    xj, wj, xt, wt = _inputs(getattr(jnp, dtype))
    kernel = np.asarray(_rms_norm_fwd_pallas(xj, wj, EPS, gemma)
                        .astype(jnp.float32))
    ref = np.asarray(jax_rms_norm_ref(xj, wj, EPS, gemma).astype(jnp.float32))
    out = rms_norm(xt, wt, EPS, gemma)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    got = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, kernel, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    else:  # within one bf16 ulp of either
        for want in (kernel, ref):
            ulp = np.spacing(np.abs(want)) * 2.0 ** 16
            assert np.all(np.abs(got - want) <= ulp + 1e-30)
    np.testing.assert_array_equal(got, rms_norm_ref(xt, wt, EPS, gemma)
                                  .float().numpy())


def test_launch_counter_stays_zero_on_cpu():
    _, _, xt, wt = _inputs(jnp.float32)
    rms_norm(xt, wt, EPS)
    assert rms_norm.launches == 0
