"""Seeded weights of a Mamba-2 model, made on the device in one large draw per
leaf, in the tree the port's model code reads: ``{"embed": {"tok"},
"units": {"L0": {"ln", "mamba": {...}}}, "final_ln"}``, each layer's leaves
stacked on a leading layer axis.

The same seed gives the same tensors on the same device. The benchmark hands
them to the program and, made again from the seed, to the plain reference.
The scales follow the published model's initialisation (embedding std 0.02,
projections ``fan_in ** -0.5``, ``A`` in [1, 16], ``dt`` log-uniform in
[0.001, 0.1]); norms, biases and ``D`` get small random offsets so that no
leaf holds a constant.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from portbench.counts import Mamba2

DT_MIN, DT_MAX = 1e-3, 1e-1


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def make(m: Mamba2, seed: int, device, nodes: Optional[int] = None,
         dtype=torch.float32) -> dict:
    """The weights of ``m`` from ``seed``. ``nodes`` adds a leading axis of
    that many independently drawn models (one per FL node)."""
    g = generator(seed, device)
    lead = () if nodes is None else (int(nodes),)
    L, D, di, H = m.n_layer, m.d_model, m.d_inner, m.n_heads
    G, N, K = m.ngroups, m.d_state, m.d_conv

    def normal(shape, std, mean=0.0):
        t = torch.randn(lead + tuple(shape), generator=g, device=device, dtype=torch.float32)
        return t.mul_(std).add_(mean).to(dtype)

    def uniform(shape, lo, hi):
        t = torch.rand(lead + tuple(shape), generator=g, device=device, dtype=torch.float32)
        return t.mul_(hi - lo).add_(lo)

    dt = torch.exp(uniform((L, H), math.log(DT_MIN), math.log(DT_MAX)))
    mamba = {
        "wz": normal((L, D, di), D ** -0.5),
        "wx": normal((L, D, di), D ** -0.5),
        "wB": normal((L, D, G, N), D ** -0.5),
        "wC": normal((L, D, G, N), D ** -0.5),
        "wdt": normal((L, D, H), D ** -0.5),
        # the inverse softplus of dt, so softplus(dt_bias) = dt
        "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(dtype),
        "conv_wx": normal((L, K, di), K ** -0.5),
        "conv_bx": normal((L, di), 0.1),
        "conv_wB": normal((L, K, G * N), K ** -0.5),
        "conv_bB": normal((L, G * N), 0.1),
        "conv_wC": normal((L, K, G * N), K ** -0.5),
        "conv_bC": normal((L, G * N), 0.1),
        "A_log": torch.log(uniform((L, H), 1.0, 16.0)).to(dtype),
        "D_skip": normal((L, H), 0.1, mean=1.0),
        "norm": normal((L, di), 0.1),
        "out": normal((L, di, D), di ** -0.5),
    }
    return {
        "embed": {"tok": normal((m.vocab_size, D), 0.02)},
        "units": {"L0": {"ln": normal((L, D), 0.1), "mamba": mamba}},
        "final_ln": normal((D,), 0.1),
    }


def leaves(tree: dict, prefix: str = ""):
    """``(path, tensor)`` of a nested dict in sorted key order (the order the
    fused exchange lays leaves out in)."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from leaves(v, path + ".")
        else:
            yield path, v
