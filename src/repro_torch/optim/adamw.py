"""AdamW in PyTorch ops: cosine/warmup schedule, global-norm clipping, and
float32 / bfloat16 / int8 moment storage.

Counterpart of the JAX package's ``optim/adamw.py``, as a pure function of
(params, grads, state) on one node's tree. The FL trainer keeps one state per
node, so clipping uses each node's own gradient norm. int8 moments are
row-wise symmetric (one float32 scale per trailing-axis row), quantized as
the jitted reference quantizes them, bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.compress import INV127
from repro_torch.pytree import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    dtype: str = "float32"       # float32 | bfloat16 | int8


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Learning rate at ``step`` (int tensor), in float32 like the reference."""
    dev = step.device
    s = step.to(torch.float32)
    warm = _f32(cfg.peak_lr, dev) * (s + 1) / max(cfg.warmup_steps, 1)
    t = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = _f32(cfg.peak_lr, dev) * (
        cfg.end_lr_frac + (1 - cfg.end_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    )
    return torch.where(step < cfg.warmup_steps, warm, cos).to(torch.float32)


class QTensor(NamedTuple):
    q: torch.Tensor        # int8, the param's shape
    scale: torch.Tensor    # float32, param.shape[:-1] + (1,)


def _quantize(x: torch.Tensor) -> QTensor:
    """Row-wise int8 codes: the scale ``max(absmax, 1e-12) * fl(1/127)``, as
    the jitted reference computes it, and the codes a true division by it,
    rounded half to even."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-12) * INV127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale.to(torch.float32))


def _store(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _quantize(x)
    return x.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _load(x) -> torch.Tensor:
    if isinstance(x, QTensor):
        return x.q.to(torch.float32) * x.scale
    return x.to(torch.float32)


def init_opt_state(params: Any, cfg: OptConfig) -> Dict[str, Any]:
    def zeros_like_store(p):
        return _store(torch.zeros(p.shape, dtype=torch.float32, device=p.device), cfg.dtype)

    device = tree_leaves(params)[0].device
    return {
        "mu": tree_map(zeros_like_store, params),
        "nu": tree_map(zeros_like_store, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree)))


def _flat_with_q(tree: Any):
    """Leaves of a moment tree in tree order, a QTensor counting as one."""
    if isinstance(tree, QTensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_with_q(tree[k])
    elif isinstance(tree, (list, tuple)):
        for c in tree:
            yield from _flat_with_q(c)
    elif tree is not None:
        yield tree


def _step_scalars(grads: Any, state: Dict[str, Any], cfg: OptConfig):
    """(new count, lr, grad norm, clip factor, bias corrections 1 and 2)."""
    count = state["count"] + 1
    lr = schedule(state["count"], cfg)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    cnt = count.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(cfg.b1, cnt.device), cnt)
    bc2 = 1 - torch.pow(_f32(cfg.b2, cnt.device), cnt)
    return count, lr, gnorm, clip, bc1, bc2


def _update_leaf(p, g, mu_s, nu_s, cfg: OptConfig, lr, clip, bc1, bc2):
    """One leaf's AdamW update -> (new param, stored mu, stored nu)."""
    g = g.to(torch.float32) * clip
    mu = cfg.b1 * _load(mu_s) + (1 - cfg.b1) * g
    nu = cfg.b2 * _load(nu_s) + (1 - cfg.b2) * torch.square(g)
    upd = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
    if p.dtype.is_floating_point:
        p32 = p.to(torch.float32)
        new_p = (p32 - lr * (upd + cfg.weight_decay * p32)).to(p.dtype)
    else:  # non-float leaves pass through
        new_p = p
    return new_p, _store(mu, cfg.dtype), _store(nu, cfg.dtype)


def apply_updates(params: Any, grads: Any, state: Dict[str, Any], cfg: OptConfig
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step on one node's tree; returns new tensors (a copy of
    params and state stepped by :func:`apply_updates_`)."""
    new_params = tree_map(torch.clone, params)
    new_state = tree_map(torch.clone, state)
    metrics = apply_updates_(new_params, tree_leaves(grads), new_state, cfg)
    return new_params, new_state, metrics


# elements of one piece of a large leaf in the in-place update
INPLACE_CHUNK = 1 << 24


def _write(dst, src) -> None:
    if isinstance(dst, QTensor):
        dst.q.copy_(src.q)
        dst.scale.copy_(src.scale)
    else:
        dst.copy_(src)


def _rows(x, sl):
    return QTensor(q=x.q[sl], scale=x.scale[sl]) if isinstance(x, QTensor) else x[sl]


def apply_updates_(params: Any, grads: list, state: Dict[str, Any], cfg: OptConfig
                   ) -> Dict[str, torch.Tensor]:
    """One AdamW step written into ``params`` and the moments of ``state``
    in place (the reference's jit donates the state; a float32 model of
    2.5 B params cannot hold a second copy of params and moments beside
    the first on one card). ``grads`` is a list
    of the leaves' gradients in tree order; each entry is dropped once its
    leaf is updated, and a leaf of more than ``INPLACE_CHUNK`` elements and
    two or more dims is updated ``INPLACE_CHUNK``-sized runs of rows at a
    time (the update is elementwise, int8 moments are quantized per last-axis
    row), so the step's scratch stays one run's. Returns the metrics; the
    count advances in place."""
    count, lr, gnorm, clip, bc1, bc2 = _step_scalars(grads, state, cfg)
    flat_p = tree_leaves(params)
    flat_mu = list(_flat_with_q(state["mu"]))
    flat_nu = list(_flat_with_q(state["nu"]))
    for i, (p, m, n) in enumerate(zip(flat_p, flat_mu, flat_nu)):
        g = grads[i]
        grads[i] = None
        rows = p.shape[0] if p.dim() >= 2 else 1
        per = max(1, rows * INPLACE_CHUNK // max(p.numel(), 1))
        for r0 in range(0, rows, per):
            sl = slice(r0, r0 + per) if p.dim() >= 2 else slice(None)
            new_p, new_m, new_n = _update_leaf(p[sl], g[sl], _rows(m, sl), _rows(n, sl),
                                               cfg, lr, clip, bc1, bc2)
            p[sl].copy_(new_p)
            _write(_rows(m, sl), new_m)
            _write(_rows(n, sl), new_n)
        del g
    state["count"].copy_(count)
    return {"grad_norm": gnorm, "lr": lr}
