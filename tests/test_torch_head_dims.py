"""The attention kernels' plain versions at the head dims of the small
Llama-family models, against the JAX package on the CPU: K16 (the bundled
flash kernels) at head dim 64 (Llama-3.2-1B, Qwen2.5-0.5B's 7:1 GQA) and
256 (Gemma-1) against ``_tpu_flash`` in interpret mode; K18 (the splash
kernels) at head dim 64 with a window and with a softcap against
``_tpu_splash(..., interpret=True)``; gpt-oss's sinks on a row where the
window is not narrow (splash, then the chunked logsumexp and the sink
rescale) against JAX's same three steps; and the dispatch: a tensor off
the CPU at these head dims reaches the kernel wrappers, never the plain
versions."""

import importlib
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from unsloth_tpu.ops.attention import (_apply_sinks, _chunked_lse, _tpu_flash,
                                      _tpu_splash)
from unsloth_tpu_torch import kernels
from unsloth_tpu_torch.ops import flash_attention as tfa
from unsloth_tpu_torch.ops import flash_sinks as tfs
from unsloth_tpu_torch.ops import splash_attention as tsa
from tests.test_torch_gemma2 import _splash_inputs
from tests.test_torch_unpacked import _padded_qkv

tatt = importlib.import_module("unsloth_tpu_torch.ops.attention")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_grads(got, want, tol=1e-4):
    """Each gradient within ``tol`` of its largest value (fp32 sums in other
    orders), as the K16/K18 twin tests hold them."""
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= tol * np.abs(w).max()


# ---------------------------------------------------------------------------
# K16 at head dims 64 and 256
# ---------------------------------------------------------------------------

#: id -> (head dim, query heads, kv heads): Qwen2.5-0.5B's 7 query heads a
#: kv head, Llama-3.2-1B's 4 (32/8), Gemma-1's head dim 256 without GQA
FLASH_CASES = {"d64-gqa7": (64, 7, 1), "d64-gqa4": (64, 8, 2),
               "d256": (256, 2, 2)}


@pytest.fixture(scope="module", params=list(FLASH_CASES))
def jax_flash(request):
    """_tpu_flash in interpret mode on a full and a padded row: out and
    d(sum out * dout)/d(q, k, v)."""
    d, hq, hkv = FLASH_CASES[request.param]
    q, k, v, dout, seg = _padded_qkv(seed=11, hq=hq, hkv=hkv, d=d)
    scale = d ** -0.5

    def f(q_, k_, v_):
        return _tpu_flash(q_, k_, v_, causal=True,
                          segment_ids=jnp.asarray(seg), scale=scale)

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        out = f(*args)
        grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(dout)),
                         argnums=(0, 1, 2))(*args)
    return (q, k, v, dout, seg), np.asarray(out), [np.asarray(x)
                                                   for x in grads]


def test_flash_plain_forward_matches_pallas(jax_flash):
    """Output at every position, pad queries included, f32: 1e-5."""
    (q, k, v, _, seg), want, _ = jax_flash
    got = tfa.flash_attention(_t(q), _t(k), _t(v), _t(seg))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_flash_plain_grads_match_pallas(jax_flash):
    """dq, dk, dv (dk/dv summed over each kv head's 1, 4 or 7 query heads)
    at every position, f32: 1e-4 of the largest value."""
    (q, k, v, dout, seg), _, want = jax_flash
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, _t(seg))
    torch.autograd.backward(out, _t(dout))
    _assert_grads([x.grad.numpy() for x in (tq, tk, tv)], want)


# ---------------------------------------------------------------------------
# K18 at head dim 64
# ---------------------------------------------------------------------------

#: id -> (query heads, kv heads, window, softcap, scale): gpt-oss's sliding
#: layers' form (8 query heads a kv head, window 128, no softcap; the
#: window bites at T = 256), a softcap of 50 alone, and both
SPLASH64_CASES = {"window": (8, 1, 128, None, 0.125),
                  "softcap": (4, 2, None, 50.0, 0.125),
                  "window-softcap": (4, 2, 64, 50.0, 0.1)}


@pytest.fixture(scope="module", params=list(SPLASH64_CASES))
def jax_splash64(request):
    hq, hkv, window, softcap, scale = SPLASH64_CASES[request.param]
    q, k, v, dout, seg = _splash_inputs(64, seed=12, hq=hq, hkv=hkv)

    def f(q_, k_, v_):
        return _tpu_splash(q_, k_, v_, causal=True,
                           segment_ids=jnp.asarray(seg), window=window,
                           softcap=softcap, scale=scale, interpret=True)

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(dout)),
                     argnums=(0, 1, 2))(*args)
    opts = dict(window=window, softcap=softcap, scale=scale)
    return (q, k, v, dout, seg), opts, np.asarray(out), [np.asarray(x)
                                                         for x in grads]


def test_splash64_plain_forward_matches_pallas(jax_splash64):
    """Output at every position of a padded and a packed row, f32: 1e-5."""
    (q, k, v, _, seg), opts, want, _ = jax_splash64
    got = tsa.splash_attention(_t(q), _t(k), _t(v), _t(seg), **opts)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_splash64_plain_grads_match_pallas(jax_splash64):
    """dq, dk, dv (the softcap's 1 - tanh^2 in dS where it is set), f32:
    1e-4 of the largest value."""
    (q, k, v, dout, seg), opts, _, want = jax_splash64
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tsa.splash_attention(tq, tk, tv, _t(seg), **opts)
    torch.autograd.backward(out, _t(dout))
    _assert_grads([x.grad.numpy() for x in (tq, tk, tv)], want)


# ---------------------------------------------------------------------------
# gpt-oss's sinks on a row where the window is not narrow
# ---------------------------------------------------------------------------

SINKS_T, SINKS_WINDOW = 384, 128    # 4 bands of 128 do not fit in 384


def _sinks_inputs(seed=13, hq=8, hkv=2):
    rng = np.random.default_rng(seed)
    t = SINKS_T
    q, k, v, dout = (rng.standard_normal((1, t, h, 64)).astype(np.float32)
                     for h in (hq, hkv, hkv, hq))
    seg = np.zeros((1, t), np.int32)
    seg[0, :150], seg[0, 150:330] = 1, 2          # two documents, pad tail
    sinks = rng.standard_normal(hq).astype(np.float32)
    return q, k, v, dout, seg, sinks


def _jax_sinks_route(q, k, v, seg, sinks, scale):
    """JAX's route for sinks with a window that is not narrow
    (unsloth_tpu/ops/attention.py:656-663): splash, the chunked lse, the
    sink rescale."""
    opts = dict(causal=True, segment_ids=seg, window=SINKS_WINDOW,
                softcap=None, scale=scale)
    out = _tpu_splash(q, k, v, interpret=True, **opts)
    lse = _chunked_lse(q, k, **opts)
    return _apply_sinks(out, lse, sinks)


def _port_sinks_route(q, k, v, seg, sinks, scale):
    opts = dict(causal=True, segment_ids=seg, window=SINKS_WINDOW,
                softcap=None, scale=scale)
    out = tsa.splash_attention(q, k, v, seg, window=SINKS_WINDOW,
                               softcap=None, scale=scale)
    lse = tatt._chunked_lse(q, k, **opts)
    return tatt._apply_sinks(out, lse, sinks)


def test_sinks_route_not_narrow_matches_jax():
    """gpt-oss's sliding layer at T = 384 (window 128 is not narrow there):
    the port's splash (its plain version on the CPU), chunked lse and sink
    rescale against JAX's splash in interpret mode and its same two steps:
    output f32 1e-5; dq, dk, dv and dsinks 1e-4 of their largest values.
    The dispatcher's CPU route (attention_ref with the sink column) gives
    the same output."""
    q, k, v, dout, seg, sinks = _sinks_inputs()
    scale = 0.125
    jargs = tuple(jnp.asarray(x) for x in (q, k, v, sinks))
    jseg = jnp.asarray(seg)

    def jf(q_, k_, v_, s_):
        return _jax_sinks_route(q_, k_, v_, jseg, s_, scale)

    want = np.asarray(jf(*jargs))
    want_g = jax.grad(lambda *a: jnp.sum(jf(*a) * jnp.asarray(dout)),
                      argnums=(0, 1, 2, 3))(*jargs)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v, sinks)]
    got = _port_sinks_route(*leaves[:3], _t(seg), leaves[3], scale)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    torch.autograd.backward(got, _t(dout))
    _assert_grads([x.grad.numpy() for x in leaves],
                  [np.asarray(g) for g in want_g])
    cpu_route = tatt.attention(*(_t(x) for x in (q, k, v)), causal=True,
                               segment_ids=_t(seg), window=SINKS_WINDOW,
                               scale=scale, sinks=_t(sinks))
    np.testing.assert_allclose(cpu_route.numpy(), want, atol=1e-5)


# ---------------------------------------------------------------------------
# dispatch: off the CPU, the kernels
# ---------------------------------------------------------------------------

class _FakeLibrary:
    """Stands in for the built kernel library: records each entry point's
    head dim and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            # pointers, B, T, Hq, Hkv, D, scale, [window, softcap,]
            # stream: D is the last int but the stream (and the window)
            ints = [i for i, a in enumerate(args) if isinstance(a, int)
                    and not isinstance(a, bool)]
            self.calls.append((name, args[ints[-3] if name.startswith(
                "unsloth_splash") else ints[-2]]))
            return 0
        return call


@pytest.fixture
def fake_kernels(monkeypatch):
    """Plain versions that raise if called; the kernel library faked; the
    device check taking the meta device for the card's and keeping the
    head-dim check."""
    def no_plain(*a, **kw):
        raise AssertionError("a plain version ran on a tensor off the CPU")

    for mod in (tfa, tsa, tfs):
        for name in dir(mod):
            if name.endswith("_ref"):
                monkeypatch.setattr(mod, name, no_plain)
    check = tfa._check_kernel_inputs

    def meta_check(name, q, k, v, seg, head_dims=tfa.KERNEL_HEAD_DIMS):
        assert q.device.type == "meta"
        with pytest.raises(NotImplementedError, match="meta"):
            check(name, q, k, v, seg, head_dims)
        assert q.shape[3] in head_dims and k.shape[3] == q.shape[3]

    lib = _FakeLibrary()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    for mod in (tfa, tsa, tfs):
        monkeypatch.setattr(mod, "_check_kernel_inputs", meta_check)
        monkeypatch.setattr(mod, "_stream", lambda t: 0)
    return lib


def _meta(b, t, h, d):
    return torch.empty((b, t, h, d), device="meta", dtype=torch.bfloat16,
                       requires_grad=True)


@pytest.mark.parametrize("d,hq,hkv", [(64, 32, 8), (64, 14, 2),
                                      (256, 16, 16)])
def test_flash_dispatch_off_cpu_reaches_the_kernels(fake_kernels, d, hq,
                                                    hkv):
    """attention() on a padded batch at head dim 64 or 256, off the CPU:
    the forward launches K16's forward, the backward its dq and dk/dv, each
    once with this head dim, and no plain version runs."""
    before = [f.launches for f in (tfa.flash_attention_fwd,
                                   tfa.flash_attention_dq,
                                   tfa.flash_attention_dkv)]
    q, k, v = _meta(2, 128, hq, d), _meta(2, 128, hkv, d), _meta(2, 128,
                                                                 hkv, d)
    seg = torch.empty((2, 128), device="meta", dtype=torch.int32)
    out = tatt.attention(q, k, v, segment_ids=seg)
    out.backward(torch.empty_like(out))
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert fake_kernels.calls == [("unsloth_flash_attn_fwd", d),
                                  ("unsloth_flash_attn_dq", d),
                                  ("unsloth_flash_attn_dkv", d)]
    assert [f.launches for f in (tfa.flash_attention_fwd,
                                 tfa.flash_attention_dq,
                                 tfa.flash_attention_dkv)] == \
        [n + 1 for n in before]


@pytest.mark.parametrize("d,hq,hkv", [(64, 64, 8), (128, 32, 8),
                                      (256, 16, 8)])
def test_sinks_dispatch_off_cpu_reaches_k17(fake_kernels, d, hq, hkv):
    """attention() with sinks on plain causal rows at each head dim K17 is
    built for, off the CPU: the forward launches K17's forward, the
    backward K16's dq and dk/dv through K17's entry points, each once with
    this head dim, and no plain version runs."""
    before = [f.launches for f in (tfs.flash_sinks_fwd, tfs.flash_sinks_dq,
                                   tfs.flash_sinks_dkv)]
    q, k, v = _meta(1, 128, hq, d), _meta(1, 128, hkv, d), _meta(1, 128,
                                                                 hkv, d)
    seg = torch.empty((1, 128), device="meta", dtype=torch.int32)
    sinks = torch.empty((hq,), device="meta", requires_grad=True)
    out = tatt.attention(q, k, v, segment_ids=seg, sinks=sinks)
    out.backward(torch.empty_like(out))
    assert sinks.grad.shape == (hq,) and k.grad.shape == k.shape
    assert fake_kernels.calls == [("unsloth_flash_sinks_fwd", d),
                                  ("unsloth_flash_sinks_dq", d),
                                  ("unsloth_flash_sinks_dkv", d)]
    assert [f.launches for f in (tfs.flash_sinks_fwd, tfs.flash_sinks_dq,
                                 tfs.flash_sinks_dkv)] == \
        [n + 1 for n in before]


def test_splash_dispatch_off_cpu_reaches_the_kernels(fake_kernels):
    """gpt-oss's sliding layer with sinks at T = 384, off the CPU: K18's
    three kernels at head dim 64, then the chunked lse and the rescale
    (plain PyTorch); and head dim 64 with a softcap alone takes K18 too."""
    q, k, v = _meta(1, SINKS_T, 8, 64), _meta(1, SINKS_T, 1, 64), _meta(
        1, SINKS_T, 1, 64)
    seg = torch.empty((1, SINKS_T), device="meta", dtype=torch.int32)
    sinks = torch.empty((8,), device="meta", requires_grad=True)
    out = tatt.attention(q, k, v, segment_ids=seg, window=SINKS_WINDOW,
                         sinks=sinks)
    out.backward(torch.empty_like(out))
    assert sinks.grad.shape == (8,)
    assert fake_kernels.calls == [("unsloth_splash_attn_fwd", 64),
                                  ("unsloth_splash_attn_dq", 64),
                                  ("unsloth_splash_attn_dkv", 64)]
    fake_kernels.calls.clear()
    tatt.attention(q.detach(), k.detach(), v.detach(), softcap=30.0)
    assert fake_kernels.calls == [("unsloth_splash_attn_fwd", 64)]
