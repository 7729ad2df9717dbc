"""GaLore and Q-GaLore: low-rank gradient projection for full fine-tuning,
over torch tensors.

Counterpart of unsloth_tpu/optimizers/galore.py, with the same defaults
and the same arithmetic. Each is a transform in optax's form over a list
of tensors: ``init(params) -> state`` and ``update(grads, state) ->
(updates, state)``, the updates to be added to the params. For each 2-D
param whose shorter side is at least ``min_dim``: every ``update_proj_gap``
updates (the first included) P becomes the top-``rank`` singular vectors of
the gradient on its shorter side (``torch.linalg.svd``, plain PyTorch as
JAX's ``jnp.linalg.svd`` is no Pallas kernel) and the moments restart; the
gradient is projected, Adam runs on the projection (moments in fp32 in the
rank-r space), and the step is projected back and scaled by
``galore_scale``. Other params take plain Adam with fp32 moments. The
learning rate is ``learning_rate(count)`` with the count after the update,
as in JAX. :func:`q_galore` keeps P and both moments in int8 (blockwise
symmetric codes for P and the first moment, log-domain affine codes for the
second), dequantized for each update and quantized again after it.

An SVD's signs are arbitrary, so P may differ in sign from JAX's; Adam's
step is odd in the projected gradient, so the updates do not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Tuple, Union

import torch

Schedule = Union[float, Callable[[int], float]]


@dataclasses.dataclass
class GaloreState:
    """The update count and, for each param, its state: (P or None, m,
    v) for GaLore; the int8 codes and scales for Q-GaLore."""

    count: int
    inner: list


def _is_matrix(p: torch.Tensor, min_dim: int) -> bool:
    return p.ndim == 2 and min(p.shape) >= min_dim


def _make_proj(g: torch.Tensor, rank: int) -> torch.Tensor:
    """Top-``rank`` singular subspace of g on its shorter side: [m, r] when
    m <= n (R = P^T G), else [r, n] (R = G P^T)."""
    m, n = g.shape
    u, _, vt = torch.linalg.svd(g.to(torch.float32), full_matrices=False)
    return u[:, :rank] if m <= n else vt[:rank, :]


def _project(g: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    return proj.t() @ g if proj.shape[0] == g.shape[0] else g @ proj.t()


def _unproject(r: torch.Tensor, proj: torch.Tensor, shape) -> torch.Tensor:
    return proj @ r if proj.shape[0] == shape[0] else r @ proj


def _shapes(shape, rank: int):
    """(P's shape, the projected moments' shape) of an [m, n] param."""
    m, n = shape
    r = min(rank, m, n)
    return ((m, r), (r, n)) if m <= n else ((r, n), (m, r))


def _lr(learning_rate: Schedule, count: int) -> float:
    return float(learning_rate(count)) if callable(learning_rate) \
        else float(learning_rate)


def _adam_step(m, v, r, b1, b2, eps, count):
    """(m, v, Adam's step) for the gradient (or projection) r in fp32."""
    m = b1 * m + (1 - b1) * r
    v = b2 * v + (1 - b2) * r * r
    mh = m / (1 - b1 ** count)
    vh = v / (1 - b2 ** count)
    return m, v, mh / (torch.sqrt(vh) + eps)


@dataclasses.dataclass
class _Transform:
    init: Callable
    update: Callable


def galore(learning_rate: Schedule = 1e-4, rank: int = 128,
           update_proj_gap: int = 200, galore_scale: float = 0.25,
           b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
           min_dim: int = 256) -> _Transform:
    """GaLore with Adam in the projected space (JAX ``galore``)."""

    def init(params: List[torch.Tensor]) -> GaloreState:
        inner = []
        for p in params:
            if _is_matrix(p, min_dim):
                pshape, rshape = _shapes(p.shape, rank)
                z = lambda s: torch.zeros(s, dtype=torch.float32,  # noqa
                                          device=p.device)
                inner.append((z(pshape), z(rshape), z(rshape)))
            else:
                inner.append((None, torch.zeros_like(p, dtype=torch.float32),
                              torch.zeros_like(p, dtype=torch.float32)))
        return GaloreState(0, inner)

    def update(grads: List[torch.Tensor], state: GaloreState, params=None
               ) -> Tuple[List[torch.Tensor], GaloreState]:
        count = state.count + 1
        lr = _lr(learning_rate, count)
        refresh = (count - 1) % update_proj_gap == 0
        updates, inner = [], []
        for g, (proj, m, v) in zip(grads, state.inner):
            gf = g.to(torch.float32)
            if proj is not None:
                if refresh:
                    proj = _make_proj(gf, min(rank, *g.shape))
                    m, v = torch.zeros_like(m), torch.zeros_like(v)
                m, v, step = _adam_step(m, v, _project(gf, proj), b1, b2,
                                        eps, count)
                upd = -lr * galore_scale * _unproject(step, proj, g.shape)
            else:
                m, v, step = _adam_step(m, v, gf, b1, b2, eps, count)
                upd = -lr * step
            updates.append(upd.to(g.dtype))
            inner.append((proj, m, v))
        return updates, GaloreState(count, inner)

    return _Transform(init, update)


# ---------------------------------------------------------------------------
# Q-GaLore: int8 optimizer state and projector
# ---------------------------------------------------------------------------

_QBLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.to(torch.float32).reshape(-1)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % _QBLOCK)
                                   ).reshape(-1, _QBLOCK)


def _q8(x: torch.Tensor):
    """Blockwise symmetric int8 codes (block 256 over the flattened tensor):
    (codes int8 [nb, 256], scales fp32 [nb], shape)."""
    fp = _blocks(x)
    s = fp.abs().amax(dim=-1)
    s = torch.where(s == 0, torch.ones_like(s), s) / 127.0
    return (torch.round(fp / s[:, None]).to(torch.int8), s, tuple(x.shape))


def _dq8(codes: torch.Tensor, scales: torch.Tensor, shape) -> torch.Tensor:
    n = math.prod(shape)
    return (codes.to(torch.float32) * scales[:, None]).reshape(-1)[:n] \
        .reshape(shape)


def _q8_log(x: torch.Tensor):
    """Blockwise int8 codes of a non-negative tensor in the log domain,
    affine per block: (codes int8, scale fp32, offset fp32, shape)."""
    lv = torch.log(_blocks(x) + 1e-20)
    lo = lv.amin(dim=-1)
    hi = lv.amax(dim=-1)
    scale = torch.clamp(hi - lo, min=1e-6) / 254.0
    codes = torch.round((lv - lo[:, None]) / scale[:, None] - 127.0)
    return (torch.clamp(codes, -127, 127).to(torch.int8), scale, lo,
            tuple(x.shape))


def _dq8_log(codes, scale, lo, shape) -> torch.Tensor:
    lv = (codes.to(torch.float32) + 127.0) * scale[:, None] + lo[:, None]
    v = torch.exp(lv).reshape(-1)[:math.prod(shape)].reshape(shape)
    return torch.where(v <= 2e-20, torch.zeros_like(v), v)


def q_galore(learning_rate: Schedule = 1e-4, rank: int = 128,
             update_proj_gap: int = 200, galore_scale: float = 0.25,
             b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
             min_dim: int = 256) -> _Transform:
    """Q-GaLore (JAX ``q_galore``): GaLore with int8 moments and an int8
    projection matrix. Each param's state is (P codes, P scales, m codes,
    m scales, v codes, v scales, v offsets), P's two entries None for
    params that take plain Adam."""

    def quantized(proj, m, v):
        pq, ps, _ = _q8(proj) if proj is not None else (None, None, None)
        mq, ms, _ = _q8(m)
        vq, vs, vo, _ = _q8_log(v)
        return (pq, ps, mq, ms, vq, vs, vo)

    def init(params: List[torch.Tensor]) -> GaloreState:
        inner = []
        for p in params:
            z = lambda s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
            if _is_matrix(p, min_dim):
                pshape, rshape = _shapes(p.shape, rank)
                inner.append(quantized(z(pshape), z(rshape), z(rshape)))
            else:
                inner.append(quantized(None, z(p.shape), z(p.shape)))
        return GaloreState(0, inner)

    def update(grads: List[torch.Tensor], state: GaloreState, params=None
               ) -> Tuple[List[torch.Tensor], GaloreState]:
        count = state.count + 1
        lr = _lr(learning_rate, count)
        refresh = (count - 1) % update_proj_gap == 0
        updates, inner = [], []
        for g, (pq, ps, mq, ms, vq, vs, vo) in zip(grads, state.inner):
            gf = g.to(torch.float32)
            if pq is not None:
                pshape, rshape = _shapes(g.shape, rank)
                if refresh:
                    proj = _make_proj(gf, min(rank, *g.shape))
                    m = torch.zeros(rshape, dtype=torch.float32,
                                    device=g.device)
                    v = torch.zeros_like(m)
                else:
                    proj = _dq8(pq, ps, pshape)
                    m = _dq8(mq, ms, rshape)
                    v = _dq8_log(vq, vs, vo, rshape)
                m, v, step = _adam_step(m, v, _project(gf, proj), b1, b2,
                                        eps, count)
                upd = -lr * galore_scale * _unproject(step, proj, g.shape)
            else:
                proj = None
                m, v, step = _adam_step(
                    _dq8(mq, ms, g.shape), _dq8_log(vq, vs, vo, g.shape),
                    gf, b1, b2, eps, count)
                upd = -lr * step
            updates.append(upd.to(g.dtype))
            inner.append(quantized(proj, m, v))
        return updates, GaloreState(count, inner)

    return _Transform(init, update)


def state_memory_ratio(params: List[torch.Tensor], rank: int = 128,
                       min_dim: int = 256) -> float:
    """Optimizer-state floats per parameter (Adam = 2.0)."""
    total = state = 0
    for p in params:
        total += p.numel()
        if _is_matrix(p, min_dim):
            m, n = p.shape
            r = min(rank, m, n)
            state += 2 * r * max(m, n) + r * min(m, n)
        else:
            state += 2 * p.numel()
    return state / max(total, 1)


def state_bytes(state: GaloreState) -> int:
    """Bytes of every tensor in a GaLore or Q-GaLore state."""
    return sum(t.numel() * t.element_size() for entry in state.inner
               for t in entry if isinstance(t, torch.Tensor))
