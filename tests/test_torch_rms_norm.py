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


# ---------------------------------------------------------------------------
# the backward kernels' form (K4, K6) and the check phase 3 holds them to
# ---------------------------------------------------------------------------

import torch  # noqa: E402

from chip_smoke import (ln_bwd_errs, norm_bwd_faults,  # noqa: E402
                        rms_bwd_errs)
from unsloth_tpu_torch.ops.rms_norm import (  # noqa: E402
    NORM_BLOCKS_PER_SM, NORM_CHUNKS, NORM_LANE_REGS, layer_norm_bwd_ref,
    norm_bwd_form, norm_lane_registers, rms_norm_bwd_ref)

#: the hidden widths of the main paths: Qwen2.5-0.5B, Whisper-large-v3,
#: Llama-3.2-1B, gpt-oss-20b, Orpheus-3B and Gemma-7B, Gemma-2-9B,
#: Llama-3.1-8B
PATH_WIDTHS = (896, 1280, 2048, 2880, 3072, 3584, 4096)


@pytest.mark.parametrize("d", PATH_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_bwd_form_at_path_widths(d, dtype):
    """K4's and K6's form at every main path's width: the row form, whose
    lanes cover the row in at most NORM_CHUNKS chunks each within the
    lane budget the kernels assume with the dW (and dB) columns; the same
    layout with and without dW (dx the same bits); a grid of at most a
    wave, its rounds even, every block with rows; dW's groups of
    ceil(sqrt(blocks)) blocks and the scratch they need."""
    per_chunk = 16 // torch.empty((), dtype=dtype).element_size()
    for layer in (False, True):
        sums = 2 if layer else 1
        for rows in (448, 2048, 3000, 8192):
            for occupancy in (2, 4):
                dx_only = norm_bwd_form(rows, d, dtype, False, layer,
                                        blocks_per_sm=occupancy)
                form = norm_bwd_form(rows, d, dtype, True, layer,
                                     blocks_per_sm=occupancy)
                assert dx_only[:3] == form[:3] and dx_only.group_blocks == 0
                c, w = form.chunks, form.warps_per_row
                assert c in NORM_CHUNKS and w in (1, 2, 4, 8)
                assert c * 32 * w >= d // per_chunk
                assert norm_lane_registers(c, per_chunk, sums) \
                    <= NORM_LANE_REGS
                units = -(-rows // form.rows_per_block)
                rounds = -(-units // form.blocks)
                assert form.blocks <= occupancy * 132
                assert (rounds - 1) * form.blocks < units
                assert torch.equal(torch.unique(form.block_of_rows(rows)),
                                   torch.arange(form.blocks))
                q = form.group_blocks
                assert (q - 1) ** 2 < form.blocks <= q * q
                floats, counters = form.scratch(d, sums)
                assert counters == form.groups + 1 == -(-form.blocks // q) + 1
                assert floats == (form.blocks + form.groups) * sums * d


@pytest.mark.parametrize("d,dtype,aligned,chunks", [
    (1288, torch.bfloat16, True, 2), (1282, torch.bfloat16, True, 0),
    (1280, torch.bfloat16, False, 0), (7000, torch.bfloat16, True, 4),
    (7000, torch.float32, True, 0), (384, torch.bfloat16, True, 2)])
def test_norm_bwd_form_takes_the_strided_form(d, dtype, aligned, chunks):
    """Widths that are no whole number of chunks, tensors that are not
    16-byte aligned and rows wider than the lanes' budget hold take the
    strided form (chunks 0, a block a row); K4's rows at 7,000 bf16
    still fit."""
    form = norm_bwd_form(70, d, dtype, True, aligned=aligned)
    assert form.chunks == chunks
    assert (form.warps_per_row == 8) if chunks == 0 else True


@pytest.mark.parametrize("layer", [False, True])
def test_norm_bwd_check_rejects_faults(layer):
    """Phase 3's checks of K4 and K6 (chip_smoke.rms_bwd_errs,
    ln_bwd_errs) pass the plain version and reject each planted fault of
    chip_smoke.norm_bwd_faults: dW (and dB) without one block's partial
    row, dx without its mean term; bf16, 512 rows of 1,280."""
    gen = torch.Generator().manual_seed(7)
    x = (torch.randn((512, 1280), generator=gen) * 2 + 0.5).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(1280, generator=gen)).to(torch.bfloat16)
    gy = torch.randn((512, 1280), generator=gen).to(torch.bfloat16)
    form = norm_bwd_form(512, 1280, torch.bfloat16, True, layer)
    ref = (layer_norm_bwd_ref(x, w, gy, 1e-5) if layer
           else rms_norm_bwd_ref(x, w, gy, 1e-5, True))

    def errs(got):
        return (ln_bwd_errs if layer else rms_bwd_errs)(torch.bfloat16, got,
                                                         ref)

    assert max(errs(ref).values()) == 0.0
    assert list(errs((ref[0],) + (None,) * (len(ref) - 1))) == ["dx"]
    faults = norm_bwd_faults(x, w, gy, 1e-5, form, gemma=not layer,
                             layer=layer)
    assert len(faults) == 2
    for name, got in faults.items():
        assert max(errs(got).values()) > 1.0, name


def test_device_scratch_is_one_per_stream():
    """The scratch of the one-launch sums (K4's and K6's dW form, the
    decode matmuls): one stream reuses its buffers and grows them where a
    call needs more, another stream gets buffers of its own, and the
    counters start at zero."""
    from unsloth_tpu_torch import kernels

    dev = torch.device("cpu")
    first = kernels.device_scratch(10, 5, dev, 1001)
    assert kernels.device_scratch(100, 50, dev, 1001) == first
    partials, arrivals = kernels._SCRATCH[dev, 1001]
    assert partials.numel() >= 1 << 20 and not arrivals.any()
    other = kernels.device_scratch(10, 5, dev, 1002)
    assert set(other).isdisjoint(first)
    grown = kernels.device_scratch(2 << 20, 5000, dev, 1001)
    assert grown[0] != first[0] and grown[1] != first[1]
    assert kernels._SCRATCH[dev, 1001][0].numel() == 2 << 20
    assert kernels.device_scratch(10, 5, dev, 1002) == other
    for key in ((dev, 1001), (dev, 1002)):
        del kernels._SCRATCH[key]
