"""The grouped dense matmul of the PyTorch port (K19's plain version,
``ops/gmm.py``) against the JAX package's route on the same numpy inputs,
on the CPU: megablox ``gmm`` in interpret mode, called as
unsloth_tpu/ops/moe.py's ``tiled_gmm`` calls it (K and N zero-padded to a
multiple of 128, ``transpose_rhs=True``, fp32 accumulation, the output cast
to the input dtype and the gathered bias rows added), at dims that are not
multiples of 128, with empty groups, a skewed routing and the bias; its dx
against ``jax.vjp`` of the same; and the dispatch: a tensor off the CPU
reaches the kernel wrapper, never the plain version.

Tolerance, unless a test says otherwise: 1e-5 relative plus 1e-5 absolute
in fp32 (the same fp32 products summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.megablox import gmm as megablox_gmm

from unsloth_tpu_torch import kernels
from unsloth_tpu_torch.ops import gmm as tgmm

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fit(v):
    if v % 128 == 0:
        return 128
    for t in (64, 32, 16, 8):
        if v % t == 0:
            return t
    return v


def _fit_lane(v):
    for t in (512, 256, 128):
        if v % t == 0:
            return t
    return v


def jax_tiled_gmm(lhs, rhs, sizes, bias=None):
    """JAX's route for dense experts: unsloth_tpu/ops/moe.py tiled_gmm
    (:235-254) and the bias epilogue of gmm_ (:258-276), megablox gmm in
    interpret mode as the JAX package runs it off the TPU."""
    m = lhs.shape[0]
    n0, k0 = rhs.shape[1], rhs.shape[2]
    kp, np_ = (-k0) % 128, (-n0) % 128
    lhs_p = jnp.pad(lhs, ((0, 0), (0, kp)))
    rhs_p = jnp.pad(rhs, ((0, 0), (0, np_), (0, kp)))
    out = megablox_gmm(lhs_p, rhs_p, group_sizes=sizes,
                       preferred_element_type=jnp.float32,
                       tiling=(_fit(m), _fit_lane(k0 + kp),
                               _fit_lane(n0 + np_)),
                       transpose_rhs=True, interpret=True)[:, :n0]
    out = out.astype(lhs.dtype)
    if bias is not None:
        expert_of_row = jnp.repeat(jnp.arange(rhs.shape[0]), sizes,
                                   total_repeat_length=m)
        out = out + jnp.take(bias, expert_of_row, axis=0).astype(lhs.dtype)
    return out


#: id -> (experts, N, K, group sizes): dims that are not multiples of 128;
#: empty groups; a skewed routing (one expert most rows, the last group
#: empty); one expert takes every row
CASES = {
    "empty-groups": (4, 200, 136, [0, 17, 0, 23]),
    "skewed": (5, 72, 264, [3, 50, 1, 6, 0]),
    "one-expert": (3, 136, 96, [0, 0, 41]),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    e, n, k, sizes = CASES[request.param]
    rng = np.random.default_rng(e * 100 + n)
    m = sum(sizes)
    return dict(
        w=(rng.standard_normal((e, n, k)) * 0.1).astype(np.float32),
        x=rng.standard_normal((m, k)).astype(np.float32),
        g=rng.standard_normal((m, n)).astype(np.float32),
        bias=rng.standard_normal((e, n)).astype(np.float32),
        sizes=np.asarray(sizes, np.int32))


@pytest.mark.parametrize("with_bias", [False, True])
def test_gmm_ref_forward_matches_megablox(case, with_bias):
    """gmm_ref (and gmm on a CPU tensor, which runs it) against JAX's
    tiled_gmm route, fp32; rows of empty groups included."""
    bias = case["bias"] if with_bias else None
    want = np.asarray(jax_tiled_gmm(
        jnp.asarray(case["x"]), jnp.asarray(case["w"]),
        jnp.asarray(case["sizes"]),
        None if bias is None else jnp.asarray(bias)))
    args = (_t(case["x"]), _t(case["w"]), _t(case["sizes"]))
    tb = None if bias is None else _t(bias)
    np.testing.assert_allclose(tgmm.gmm_ref(*args, tb).numpy(), want, **TOL)
    before = tgmm.gmm.launches
    np.testing.assert_allclose(tgmm.gmm(*args, tb).numpy(), want, **TOL)
    assert tgmm.gmm.launches == before   # CPU calls launch nothing


def test_gmm_ref_dx_matches_megablox_vjp(case):
    """gmm_ref(transpose=True), gmm_dx and the autograd backward of gmm
    (with the bias, which the lhs gradient does not see) against jax.vjp of
    the tiled_gmm route with respect to its lhs, fp32."""
    w, sizes = jnp.asarray(case["w"]), jnp.asarray(case["sizes"])
    bias = jnp.asarray(case["bias"])
    _, vjp = jax.vjp(lambda x_: jax_tiled_gmm(x_, w, sizes, bias),
                     jnp.asarray(case["x"]))
    (want,) = vjp(jnp.asarray(case["g"]))
    want = np.asarray(want)
    tw, ts, tg = _t(case["w"]), _t(case["sizes"]), _t(case["g"])
    np.testing.assert_allclose(
        tgmm.gmm_ref(tg, tw, ts, transpose=True).numpy(), want, **TOL)
    np.testing.assert_allclose(tgmm.gmm_dx(tg, tw, ts).numpy(), want, **TOL)
    xt = _t(case["x"]).requires_grad_(True)
    tgmm.gmm(xt, tw, ts, _t(case["bias"])).backward(tg)
    np.testing.assert_allclose(xt.grad.numpy(), want, **TOL)


def test_gmm_ref_bf16_rounds_as_jax():
    """In bf16 the product is rounded to bf16 before the bf16 bias is
    added, then rounded again, in both packages: every element within one
    bf16 ulp of its value plus 2^-8 of the output's largest (the fp32 sums
    run in another order, which can flip a product's last bit before the
    bias)."""
    e, n, k, sizes = CASES["empty-groups"]
    rng = np.random.default_rng(3)
    m = sum(sizes)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((e, n, k)) * 0.1).astype(np.float32)
    bias = rng.standard_normal((e, n)).astype(np.float32)
    want = np.asarray(jax_tiled_gmm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(sizes), jnp.asarray(bias, jnp.bfloat16)
    ).astype(jnp.float32))
    got = tgmm.gmm_ref(_t(x).bfloat16(), _t(w).bfloat16(),
                       _t(np.asarray(sizes, np.int32)),
                       _t(bias).bfloat16()).float().numpy()
    assert np.all(np.abs(got - want)
                  <= 2.0 ** -8 * np.abs(want) + 2.0 ** -8 * np.abs(want).max())
    # and the bias enters after the product's rounding: the other order
    # (one rounding of product + bias) differs from both somewhere
    fused = torch.zeros((m, n))
    start = 0
    for gi, s in enumerate(sizes):
        fused[start:start + s] = (
            _t(x).bfloat16().float()[start:start + s]
            @ _t(w).bfloat16().float()[gi].t()
            + _t(bias).bfloat16().float()[gi])
        start += s
    assert not np.array_equal(fused.bfloat16().float().numpy(), want)


def test_gmm_off_cpu_reaches_the_kernel_wrapper(monkeypatch):
    """A tensor off the CPU (meta, standing in for CUDA) goes to the kernel
    wrapper, never to gmm_ref: unpatched it raises naming the device; with
    the launcher patched, the forward and the autograd backward each call
    their C entry point once with (m, E, N, K), and count one launch."""
    def no_plain(*a, **kw):
        raise AssertionError("gmm_ref ran on a tensor off the CPU")

    monkeypatch.setattr(tgmm, "gmm_ref", no_plain)
    e, n, k, m = 3, 40, 24, 10
    x = torch.empty((m, k), device="meta", dtype=torch.bfloat16)
    w = torch.empty((e, n, k), device="meta", dtype=torch.bfloat16)
    sizes = torch.empty((e,), device="meta", dtype=torch.int32)
    bias = torch.empty((e, n), device="meta", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="meta"):
        tgmm.gmm(x, w, sizes, bias)

    calls = []

    class FakeLibrary:
        def unsloth_gmm_bf16(self, *args):
            calls.append(("fwd", args[5:9], args[2] is not None))
            return 0

        def unsloth_gmm_dx_bf16(self, *args):
            calls.append(("dx", args[4:8]))
            return 0

    monkeypatch.setattr(kernels, "library", lambda: FakeLibrary())
    monkeypatch.setattr(tgmm, "_stream", lambda t: 0)
    monkeypatch.setattr(tgmm, "_check_cuda", lambda *a: None)
    before = (tgmm.gmm.launches, tgmm.gmm_dx.launches)
    xg = x.clone().requires_grad_(True)
    y = tgmm.gmm(xg, w, sizes, bias)
    assert y.shape == (m, n) and y.device.type == "meta"
    y.backward(torch.empty((m, n), device="meta", dtype=torch.bfloat16))
    assert xg.grad.shape == (m, k)
    assert calls == [("fwd", (m, e, n, k), True), ("dx", (m, e, n, k))]
    assert (tgmm.gmm.launches, tgmm.gmm_dx.launches) == (before[0] + 1,
                                                         before[1] + 1)


def test_gmm_refuses_trainable_experts(monkeypatch):
    """Trainable experts are no longer refused: W and the bias requiring a
    gradient get tgmm's and the segment sum's gradients (on the CPU, the
    plain versions: equal to tgmm_ref and group_sum exactly, the dx to
    gmm_ref's); off the CPU (meta tensors, standing in for CUDA) the
    backward calls the dx and the tgmm C entry points once each with
    (m, E, N, K) and counts one launch of each, and never tgmm_ref."""
    w = torch.randn((2, 8, 8), requires_grad=True)
    x = torch.randn((3, 8), requires_grad=True)
    bias = torch.randn((2, 8), requires_grad=True)
    sizes = torch.tensor([1, 2], dtype=torch.int32)
    gy = torch.randn((3, 8))
    tgmm.gmm(x, w, sizes, bias).backward(gy)
    assert torch.equal(w.grad, tgmm.tgmm_ref(x.detach(), gy, sizes))
    assert torch.equal(bias.grad, tgmm.group_sum(gy, sizes, torch.float32))
    assert torch.equal(x.grad, tgmm.gmm_ref(gy, w.detach(), sizes,
                                            transpose=True))
    with torch.no_grad():
        assert tgmm.gmm(x, w, sizes).shape == (3, 8)

    def no_plain(*a, **kw):
        raise AssertionError("a plain version ran on a tensor off the CPU")

    monkeypatch.setattr(tgmm, "gmm_ref", no_plain)
    monkeypatch.setattr(tgmm, "tgmm_ref", no_plain)
    e, n, k, m = 3, 40, 24, 10
    meta = dict(device="meta", dtype=torch.bfloat16)
    x = torch.empty((m, k), **meta).requires_grad_(True)
    w = torch.empty((e, n, k), **meta).requires_grad_(True)
    sizes = torch.empty((e,), device="meta", dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="meta"):
        tgmm.tgmm(x.detach(), torch.empty((m, n), **meta), sizes)
    calls = []

    class FakeLibrary:
        def unsloth_gmm_bf16(self, *args):
            calls.append(("fwd", args[5:9]))
            return 0

        def unsloth_gmm_dx_bf16(self, *args):
            calls.append(("dx", args[4:8]))
            return 0

        def unsloth_gmm_tgmm_bf16(self, *args):
            calls.append(("tgmm", args[4:8]))
            return 0

    monkeypatch.setattr(kernels, "library", lambda: FakeLibrary())
    monkeypatch.setattr(tgmm, "_stream", lambda t: 0)
    monkeypatch.setattr(tgmm, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(tgmm, "_check_tgmm", lambda *a: None)
    before = (tgmm.gmm.launches, tgmm.gmm_dx.launches, tgmm.tgmm.launches)
    y = tgmm.gmm(x, w, sizes)
    y.backward(torch.empty((m, n), **meta))
    assert x.grad.shape == (m, k) and w.grad.shape == (e, n, k)
    assert calls == [("fwd", (m, e, n, k)), ("dx", (m, e, n, k)),
                     ("tgmm", (m, e, n, k))]
    assert (tgmm.gmm.launches, tgmm.gmm_dx.launches, tgmm.tgmm.launches) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
    # only W trained: no dx launch
    calls.clear()
    tgmm.gmm(x.detach(), w, sizes).backward(torch.empty((m, n), **meta))
    assert calls == [("fwd", (m, e, n, k)), ("tgmm", (m, e, n, k))]
