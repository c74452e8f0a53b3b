"""Plain AdamW in float32 (Loshchilov and Hutter): global-norm clipping, a
linear warm-up to the peak rate then a cosine decay to ``end_lr_frac`` of it,
bias-corrected moments, and weight decay decoupled from the gradient and
applied to every parameter. One model's list of leaves at a time."""

from __future__ import annotations

import math
from typing import List

import torch


def rate(step: int, opt: dict) -> float:
    """Learning rate of the ``step``-th update (0-based)."""
    peak, warm = opt["peak_lr"], max(opt["warmup_steps"], 1)
    if step < opt["warmup_steps"]:
        return peak * (step + 1) / warm
    t = min(max((step - opt["warmup_steps"]) / max(opt["decay_steps"] - opt["warmup_steps"], 1),
                0.0), 1.0)
    end = opt["end_lr_frac"]
    return peak * (end + (1 - end) * 0.5 * (1 + math.cos(math.pi * t)))


@torch.no_grad()
def step(params: List[torch.Tensor], grads: List[torch.Tensor], mu: List[torch.Tensor],
         nu: List[torch.Tensor], count: int, opt: dict) -> None:
    """One update of ``params``, ``mu`` and ``nu`` in place; ``count`` is the
    number of updates made before this one."""
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    clip = torch.clamp(opt["clip_norm"] / gnorm.clamp_min(1e-9), max=1.0)
    b1, b2, lr = opt["b1"], opt["b2"], rate(count, opt)
    bc1, bc2 = 1 - b1 ** (count + 1), 1 - b2 ** (count + 1)
    for p, g, m, v in zip(params, grads, mu, nu):
        g = g.float() * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        upd = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"])
        p.sub_(lr * (upd + opt["weight_decay"] * p))
