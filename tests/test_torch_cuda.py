"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need an NVIDIA GPU and nvcc; without one they skip. On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import pytest
import torch

from unsloth_tpu_torch.ops.nf4 import dequantize_nf4, quantize_nf4
from unsloth_tpu_torch.ops.qlora_matmul import nf4_matmul
from unsloth_tpu_torch.ops.rms_norm import rms_norm, rms_norm_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("m,n,k", [(1, 256, 512), (7, 200, 384),
                                   (70, 1024, 4096), (300, 4096, 4096)])
def test_nf4_matmul_kernel_matches_plain(dev, m, n, k):
    g = torch.Generator(device=dev).manual_seed(0)
    q = quantize_nf4(torch.randn((n, k), generator=g, device=dev) * 0.05)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    before = nf4_matmul.launches
    y = nf4_matmul(x, q)
    ref = torch.matmul(x, dequantize_nf4(q, torch.bfloat16).t())
    torch.cuda.synchronize()
    assert nf4_matmul.launches == before + 1
    assert y.shape == (m, n) and y.dtype == torch.bfloat16
    # same bf16 weights, fp32 sums in another order, one bf16 rounding
    assert (y.float() - ref.float()).abs().max() <= \
        1e-2 * ref.float().abs().max()


def test_nf4_matmul_kernel_refuses_f32(dev):
    q = quantize_nf4(torch.randn((128, 256), device=dev))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        nf4_matmul(torch.randn((2, 256), device=dev), q)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gemma", [False, True])
def test_rms_norm_kernel_matches_plain(dev, dtype, gemma):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((3, 5, 4096), generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(4096, generator=g, device=dev)).to(dtype)
    before = rms_norm.launches
    y = rms_norm(x, w, 1e-5, gemma)
    ref = rms_norm_ref(x, w, 1e-5, gemma)
    torch.cuda.synchronize()
    assert rms_norm.launches == before + 1
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
    assert ((y.float() - ref.float()).abs()
            <= tol * ref.float().abs() + 1e-6).all()
