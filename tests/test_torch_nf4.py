"""NF4 storage and the fused NF4 matmul of the PyTorch port against the JAX
package: same bytes from the same weights, the same dequantized values
from the same NF4 tensor, and the port's CPU path against the JAX Pallas
kernel (interpret mode) and its plain reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsloth_tpu.ops import nf4 as jnf4
from unsloth_tpu.ops.qlora_matmul import _fwd_pallas
from unsloth_tpu_torch.interop import params_from_numpy, to_tensor
from unsloth_tpu_torch.ops import nf4 as tnf4
from unsloth_tpu_torch.ops.qlora_matmul import nf4_matmul


def _weight(shape=(256, 512), seed=0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * 0.05).astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    """One NF4 tensor quantized by JAX and the same bytes in the port."""
    jq = jnf4.quantize_nf4(jnp.asarray(_weight()), dtype=jnp.float32)
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), "cpu")
    return jq, tq


@pytest.mark.parametrize("double_quant", [True, False])
def test_quantize_matches_jax(double_quant):
    w = _weight()
    jq = jnf4.quantize_nf4(jnp.asarray(w), double_quant=double_quant)
    tq = tnf4.quantize_nf4(torch.from_numpy(w), double_quant=double_quant)
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
    assert tq.absmax.dtype == (torch.int8 if double_quant else torch.float32)
    ja = np.asarray(jnf4._decode_absmax(jq))
    ta = tnf4._decode_absmax(tq).numpy()
    if not double_quant:
        np.testing.assert_array_equal(ta, ja)
        return
    # the global mean sums in another order, so a code may move by one step
    step = np.repeat(np.asarray(jq.absmax_scale), jq.double_block_size)
    step = step[:ja.shape[0]]
    assert np.all(np.abs(ta - ja) <= step * 1.01 + 1e-7)
    assert np.abs(tq.absmax.numpy().astype(int)
                  - np.asarray(jq.absmax).astype(int)).max() <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_exact_on_carried_tensor(carried, dtype):
    jq, tq = carried
    jd = np.asarray(jnf4.dequantize_nf4(jq, dtype=getattr(jnp, dtype))
                    .astype(jnp.float32))
    td = tnf4.dequantize_nf4(tq, dtype=getattr(torch, dtype)).float().numpy()
    np.testing.assert_array_equal(td, jd)


def test_nf4_matmul_cpu_f32_matches_kernel_and_ref(carried):
    jq, tq = carried
    x = np.random.default_rng(1).standard_normal((48, 512)).astype(np.float32)
    jk = np.asarray(_fwd_pallas(jnp.asarray(x), jq, bm=16, bn=128, bk=128,
                                interpret=True))
    jr = np.asarray(jnf4.nf4_matmul_ref(jnp.asarray(x), jq))
    y = nf4_matmul(torch.from_numpy(x), tq)
    assert y.dtype == torch.float32 and y.shape == (48, 256)
    np.testing.assert_allclose(y.numpy(), jk, atol=1e-5, rtol=0)
    np.testing.assert_allclose(y.numpy(), jr, atol=1e-5, rtol=0)


def test_nf4_matmul_cpu_bf16_within_one_ulp(carried):
    jq, tq = carried
    x = (np.random.default_rng(2).standard_normal((48, 512))
         .astype(np.float32))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    jk = np.asarray(_fwd_pallas(xj, jq, bm=16, bn=128, bk=128,
                                interpret=True).astype(jnp.float32))
    y = nf4_matmul(to_tensor(np.asarray(xj), "cpu"), tq)
    assert y.dtype == torch.bfloat16
    yf = y.float().numpy()
    ulp = np.spacing(np.abs(jk).astype(np.float32)) * 2.0 ** 16
    assert np.all(np.abs(yf - jk) <= ulp + 1e-30)


def test_launch_counter_stays_zero_on_cpu(carried):
    _, tq = carried
    before = nf4_matmul.launches
    nf4_matmul(torch.ones((3, 512)), tq)
    assert nf4_matmul.launches == before == 0


def test_cuda_tensor_needs_bf16(carried):
    """The wrapper refuses other dtypes before it touches the device."""
    _, tq = carried

    class FakeCuda:
        device = torch.device("cuda", 0)
        dtype = torch.float32
        shape = (1, 512)

    with pytest.raises(NotImplementedError, match="bfloat16"):
        nf4_matmul(FakeCuda(), tq)
