"""RoPE, SwiGLU and LoRA projections of the PyTorch port against the JAX
package on the same numpy inputs, in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsloth_tpu.models.config import RopeScaling as JRopeScaling
from unsloth_tpu.ops import activations as jact
from unsloth_tpu.ops import lora as jlora
from unsloth_tpu.ops import rope as jrope
from unsloth_tpu.ops.nf4 import quantize_nf4 as jquantize
from unsloth_tpu_torch.interop import lora_from_numpy, params_from_numpy
from unsloth_tpu_torch.models.config import RopeScaling
from unsloth_tpu_torch.ops import activations as tact
from unsloth_tpu_torch.ops import lora as tlora
from unsloth_tpu_torch.ops import rope as trope

LLAMA3 = dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
              high_freq_factor=4.0, original_max_position_embeddings=64)


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("scaling", [None, "llama3", "linear", "yarn",
                                     "longrope"])
def test_rope_inv_freq(scaling):
    kw = {"llama3": LLAMA3, "linear": dict(rope_type="linear", factor=4.0),
          "yarn": dict(rope_type="yarn", factor=4.0,
                       original_max_position_embeddings=64),
          "longrope": dict(rope_type="longrope", long_factor=tuple(
              1.0 + 0.1 * i for i in range(32)))}.get(scaling)
    js = JRopeScaling(**kw) if kw else None
    ts = RopeScaling(**kw) if kw else None
    want = np.asarray(jrope.rope_inv_freq(64, 500000.0, js))
    got = trope.rope_inv_freq(64, 500000.0, ts).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_rope_table_and_apply_rope_qk():
    pos = _rng().integers(0, 100, (2, 7))
    inv_j = jrope.rope_inv_freq(32, 10000.0, JRopeScaling(**LLAMA3))
    inv_t = trope.rope_inv_freq(32, 10000.0, RopeScaling(**LLAMA3))
    cj, sj = jrope.rope_table(jnp.asarray(pos), inv_j)
    ct, st = trope.rope_table(torch.from_numpy(pos), inv_t)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    q = _rng(1).standard_normal((2, 7, 4, 32)).astype(np.float32)
    k = _rng(2).standard_normal((2, 7, 2, 32)).astype(np.float32)
    qj, kj = jrope.apply_rope_qk(jnp.asarray(q), jnp.asarray(k), cj, sj)
    qt, kt = trope.apply_rope_qk(torch.from_numpy(q), torch.from_numpy(k),
                                 ct, st)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-5)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-5)


def test_swiglu():
    e = _rng(3).standard_normal((3, 64)).astype(np.float32) * 4
    g = _rng(4).standard_normal((3, 64)).astype(np.float32)
    want = np.asarray(jact.glu_for("silu")(jnp.asarray(e), jnp.asarray(g)))
    got = tact.glu_for("silu")(torch.from_numpy(e), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("base", ["dense", "nf4"])
def test_lora_matmul_nonzero_b(base):
    rng = _rng(5)
    w = (rng.standard_normal((96, 128)) * 0.05).astype(np.float32)
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    lw = jlora.LoRAWeights(
        a=jnp.asarray(rng.standard_normal((8, 128)).astype(np.float32) * 0.1),
        b=jnp.asarray(rng.standard_normal((96, 8)).astype(np.float32) * 0.1),
        scale=2.0)
    wj = jquantize(jnp.asarray(w), dtype=jnp.float32) if base == "nf4" \
        else jnp.asarray(w)
    want = np.asarray(jlora.lora_matmul(jnp.asarray(x), wj, lora=lw,
                                        bias=jnp.asarray(bias)))
    wt = params_from_numpy(jax.tree_util.tree_map(np.asarray, wj), "cpu")
    lt = lora_from_numpy(jax.tree_util.tree_map(np.asarray, lw), "cpu")
    got = tlora.lora_matmul(torch.from_numpy(x), wt, lora=lt,
                            bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
