"""Plain Metropolis gossip with blockwise int8 payloads: one mix of the nodes'
stacked parameters over one slot's contact relation.

Every node lays its parameters out as one float32 vector (leaves in sorted
key order, each row-major, zero-padded to a whole number of blocks), sends
each block as codes ``round(x / s)`` clipped to +-127 with the symmetric
scale ``s = absmax / 127``, and mixes with Metropolis weights:
``x_i' = W_ii x_i + sum_j W_ij * dequant(x_j)`` over its neighbours j, with
``W_ij = 1 / (1 + max(deg i, deg j))`` and ``W_ii = 1 - sum_j W_ij``; a node
with no link keeps its value. ``levels=7`` gives the int4 payload of the
control. Nodes are mixed one row at a time, so the working set is a few
rows.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from portbench.weights import leaves

Edge = Tuple[int, int]


def flatten(tree: dict, block: int) -> torch.Tensor:
    """A stacked tree (node axis first) -> (n, padded) float32."""
    parts = [t.reshape(t.shape[0], -1).float() for _, t in leaves(tree)]
    n, used = parts[0].shape[0], sum(p.shape[1] for p in parts)
    pad = -(-used // block) * block - used
    if pad:
        parts.append(parts[0].new_zeros((n, pad)))
    return torch.cat(parts, dim=1)


def unflatten_into(tree: dict, flat: torch.Tensor) -> None:
    """Copy a (n, padded) buffer back into the stacked tree's leaves."""
    off = 0
    for _, t in leaves(tree):
        size = t[0].numel()
        t.copy_(flat[:, off:off + size].reshape(t.shape))
        off += size


def metropolis(edges: Sequence[Edge], n: int) -> np.ndarray:
    deg = np.zeros(n, dtype=np.int64)
    links = {tuple(sorted(e)) for e in edges}
    for i, j in links:
        deg[i] += 1
        deg[j] += 1
    W = np.zeros((n, n))
    for i, j in links:
        W[i, j] = W[j, i] = 1.0 / (1.0 + max(deg[i], deg[j]))
    W[np.diag_indices(n)] = 1.0 - W.sum(axis=1)
    return W


def dequant(x: torch.Tensor, block: int, levels: int = 127) -> torch.Tensor:
    """What one node's row ``x`` (padded,) arrives as (itself when
    ``levels`` is None: an uncompressed mix)."""
    if levels is None:
        return x.float()
    xb = x.float().reshape(-1, block)
    scale = xb.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / levels
    codes = torch.clamp(torch.round(xb / scale), -levels, levels)
    codes = torch.nan_to_num(codes, nan=0.0)
    return (codes * scale).reshape(-1)


def mix_row(x: torch.Tensor, i: int, W: np.ndarray, block: int,
            levels: int = 127) -> torch.Tensor:
    """Node i's row after one mix of the (n, padded) buffer ``x``."""
    out = x[i].float() * float(W[i, i])
    for j in np.flatnonzero(W[i]):
        if j != i:
            out = out + float(W[i, j]) * dequant(x[j], block, levels)
    return out


def block_scale(x: torch.Tensor, block: int) -> torch.Tensor:
    """Per block, the largest |value| any node holds there: (nb,)."""
    return x.float().abs().reshape(x.shape[0], -1, block).amax(dim=(0, 2))


def mix_gap(got: torch.Tensor, x: torch.Tensor, edges: Sequence[Edge], block: int,
            levels: int = 127) -> float:
    """Widest gap between ``got`` (n, padded) and the mix of ``x`` over
    ``edges``, each element's gap taken in units of its block's largest
    |value| over the nodes of ``x``."""
    n = x.shape[0]
    W = metropolis(edges, n)
    scale = block_scale(x, block).clamp_min(1e-30)
    worst = 0.0
    for i in range(n):
        want = mix_row(x, i, W, block, levels)
        gap = (got[i].float() - want).abs().reshape(-1, block) / scale[:, None]
        worst = max(worst, float(torch.nan_to_num(gap, nan=float("inf")).max()))
    return worst


def mix_rows(x: torch.Tensor, edges: Sequence[Edge], block: int,
             levels: int = 127) -> torch.Tensor:
    """The whole mixed (n, padded) buffer (row by row)."""
    W = metropolis(edges, x.shape[0])
    return torch.stack([mix_row(x, i, W, block, levels) for i in range(x.shape[0])])
