"""Seeded weights of NVIDIA-Nemotron-3-Nano (``nemotron_h``), made on the
device in the tree the port's model code reads: ``{"embed": {"tok",
"head"}, "units": {"L<j>": {"ln", "mamba" | "attn" | "ffn"}}, "final_ln"}``,
one layer per pattern character, each leaf on a leading unit axis of 1.

The same seed gives the same tensors on the same device. The benchmark hands
them to the program and, made again from the seed, to the plain reference.
Each leaf is drawn in pieces along its leading axes into one float32
scratch of ``PIECE_BYTES`` (the 128 experts of one layer are 2.55 GB in
bf16). Scales: embedding std 0.02, projections and the head ``fan_in **
-0.5``, ``A`` in [1, 16], ``dt`` log-uniform in [0.001, 0.1]; norms, conv
biases and ``D`` get small random offsets so that no leaf holds a constant;
the router's selection bias is N(0, 0.02^2). The router, its bias, ``A_log``,
``D_skip`` and ``dt_bias`` are float32 (the published code computes them
so); every other leaf is in the configuration's parameter dtype.
"""

from __future__ import annotations

import math

import torch

from portbench.counts_nemotron_h import NemotronH

PIECE_BYTES = 2 << 30
DT_MIN, DT_MAX = 1e-3, 1e-1
BIAS_STD = 0.02


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


class _Draw:
    """Leaves drawn in order from one generator, each in pieces through one
    float32 scratch buffer (fresh temporaries of each piece's size would
    split the allocator's blocks until 63 GB no longer fit)."""

    def __init__(self, seed: int, device, dtype):
        self.g = generator(seed, device)
        self.device = device
        self.dtype = dtype
        self.scratch = torch.empty(0, dtype=torch.float32, device=device)

    def _fill(self, shape, dtype, draw, scale, shift):
        out = torch.empty((1,) + tuple(shape), dtype=dtype, device=self.device)
        flat = out.view(-1, *shape[-1:]) if len(shape) > 1 else out.view(1, -1)
        rows = max(1, PIECE_BYTES // (4 * flat.shape[1]))
        for r0 in range(0, flat.shape[0], rows):
            n = min(rows, flat.shape[0] - r0)
            if self.scratch.numel() < n * flat.shape[1]:
                self.scratch = None
                self.scratch = torch.empty(n * flat.shape[1], dtype=torch.float32,
                                           device=self.device)
            t = self.scratch[:n * flat.shape[1]].view(n, flat.shape[1])
            draw(t.shape, generator=self.g, device=self.device, dtype=torch.float32, out=t)
            flat[r0:r0 + n].copy_(t.mul_(scale).add_(shift))
        return out

    def normal(self, shape, std, mean=0.0, dtype=None):
        return self._fill(shape, dtype or self.dtype, torch.randn, std, mean)

    def uniform(self, shape, lo, hi):
        return self._fill(shape, torch.float32, torch.rand, hi - lo, lo)


def _mamba(d: _Draw, m: NemotronH) -> dict:
    D, di, H = m.hidden_size, m.d_inner, m.mamba_num_heads
    G, N, K = m.n_groups, m.ssm_state_size, m.conv_kernel
    f32 = torch.float32
    dt = torch.exp(d.uniform((H,), math.log(DT_MIN), math.log(DT_MAX)))
    return {
        "wz": d.normal((D, di), D ** -0.5),
        "wx": d.normal((D, di), D ** -0.5),
        "wB": d.normal((D, G, N), D ** -0.5),
        "wC": d.normal((D, G, N), D ** -0.5),
        "wdt": d.normal((D, H), D ** -0.5),
        # the inverse softplus of dt, so softplus(dt_bias) = dt
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "conv_wx": d.normal((K, di), K ** -0.5),
        "conv_bx": d.normal((di,), 0.1),
        "conv_wB": d.normal((K, G * N), K ** -0.5),
        "conv_bB": d.normal((G * N,), 0.1),
        "conv_wC": d.normal((K, G * N), K ** -0.5),
        "conv_bC": d.normal((G * N,), 0.1),
        "A_log": torch.log(d.uniform((H,), 1.0, 16.0)),
        "D_skip": d.normal((H,), 0.1, mean=1.0, dtype=f32),
        "norm": d.normal((di,), 0.1),
        "out": d.normal((di, D), di ** -0.5),
    }


def _attn(d: _Draw, m: NemotronH) -> dict:
    D, H, KV, hd = (m.hidden_size, m.num_attention_heads, m.num_key_value_heads,
                    m.head_dim)
    return {
        "wq": d.normal((D, H, hd), D ** -0.5),
        "wk": d.normal((D, KV, hd), D ** -0.5),
        "wv": d.normal((D, KV, hd), D ** -0.5),
        "wo": d.normal((H, hd, D), (H * hd) ** -0.5),
    }


def _expert(d: _Draw, lead, D: int, F: int) -> dict:
    return {"wi": d.normal(lead + (D, F), D ** -0.5), "wo": d.normal(lead + (F, D), F ** -0.5)}


def _moe(d: _Draw, m: NemotronH) -> dict:
    D, E = m.hidden_size, m.n_routed_experts
    p = {"router": d.normal((D, E), D ** -0.5, dtype=torch.float32),
         "router_bias": d.normal((E,), BIAS_STD, dtype=torch.float32)}
    p.update(_expert(d, (E,), D, m.moe_intermediate_size))
    p["shared"] = _expert(d, (), D, m.moe_shared_expert_intermediate_size)
    return p


def make(m: NemotronH, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights of ``m`` from ``seed``, params in ``dtype``."""
    if m.num_hidden_layers != len(m.pattern):
        raise ValueError("the weights hold one unit: num_hidden_layers must be the "
                         f"pattern's length {len(m.pattern)}")
    d = _Draw(seed, device, dtype)
    D = m.hidden_size
    embed = {"tok": d.normal((m.vocab_size, D), 0.02)[0],
             "head": d.normal((D, m.vocab_size), D ** -0.5)[0]}
    units = {}
    for j, kind in enumerate(m.pattern):
        layer = {"ln": d.normal((D,), 0.1)}
        if kind == "M":
            layer["mamba"] = _mamba(d, m)
        elif kind == "*":
            layer["attn"] = _attn(d, m)
        elif kind == "E":
            layer["ffn"] = _moe(d, m)
        else:
            layer["ffn"] = _expert(d, (), D, m.intermediate_size)
        units[f"L{j}"] = layer
    final = d.normal((D,), 0.1)[0]
    del d
    return {"embed": embed, "units": units, "final_ln": final}
