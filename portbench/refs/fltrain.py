"""Plain TDM-FLA training: the satellites' local AdamW steps on the plain
Mamba-2 model in float32 (TF32 off), then one plain Metropolis int8 mix a
round over that round's relation, from the benchmark's seeded weights and
tokens. It follows the first rounds of a cell and reads what the program's
set-up read, for :func:`gaps` to compare.

``prec="fp8"`` is the control (the model's products in float8); the
``fault`` variants plant the faults a training cell can have: ``"half_batch"``
(half of each batch left out, the mean taken over the rest),
``"no_exchange"`` (the mix between satellites left out) and ``"grad"`` (an
answer altered where it is produced: the out projection's gradient doubled).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import weights
from portbench.refs import adamw, gossip, mamba2

LEVELS = {"int8": 127}
GRAD_FAULT_LEAF = "units.L0.mamba.out"


@dataclasses.dataclass
class Readings:
    losses: List[float]                       # each round's mean loss
    mu: Dict[str, np.ndarray]                 # |first moment| after round 1, (nodes,)
    change: Dict[str, np.ndarray]             # |param - start| after the rounds, (nodes,)
    grad: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)  # |first grad|


def _tree(paths: List[str], leaves: List[torch.Tensor]) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        *parents, last = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def follow(run, batch_fn: Callable, prec: str = "f32", fault: Optional[str] = None
           ) -> Readings:
    """The first ``checked_rounds`` rounds of ``run``'s cell, plainly."""
    t, dep = run.traffic, run.config["deployment"]
    n, H, rounds = dep["satellites"], t["local_steps"], t["checked_rounds"]
    levels = LEVELS.get(t["compression"])
    sizes, eps, dev = run.sizes, run.config["norm_eps"], run.device
    with mamba2.exact_matmuls():
        p0 = dict(weights.leaves(weights.make(sizes, run.seed, dev)))
        paths = list(p0)
        P = [p0[k].float().unsqueeze(0).repeat((n,) + (1,) * p0[k].dim()) for k in paths]
        mu = [torch.zeros_like(x) for x in P]
        nu = [torch.zeros_like(x) for x in P]
        out = Readings(losses=[], mu={}, change={})
        grad = np.zeros((len(paths), n))
        for rnd in range(rounds):
            b = {k: torch.as_tensor(v, device=dev).long() for k, v in batch_fn(run, rnd).items()}
            losses = []
            for i in range(n):
                for h in range(H):
                    tok, lab = b["tokens"][i, h], b["labels"][i, h]
                    if fault == "half_batch":
                        tok, lab = tok[: tok.shape[0] // 2], lab[: lab.shape[0] // 2]
                    leaves = [x[i].detach().requires_grad_(True) for x in P]
                    loss = mamba2.loss(_tree(paths, leaves), tok, lab, sizes, eps, prec)
                    g = list(torch.autograd.grad(loss, leaves))
                    if fault == "grad":
                        k = paths.index(GRAD_FAULT_LEAF)
                        g[k] = g[k] * 2
                    if rnd == 0 and h == 0:
                        grad[:, i] = [float(x.double().norm()) for x in g]
                    adamw.step([x[i] for x in P], g, [m[i] for m in mu], [v[i] for v in nu],
                               rnd * H + h, t["optimizer"])
                    losses.append(float(loss.detach()))
            out.losses.append(float(np.mean(losses)))
            if rnd == 0:
                out.mu = {k: m.reshape(n, -1).double().norm(dim=1).cpu().numpy()
                          for k, m in zip(paths, mu)}
            rel = dep["relations"][rnd % len(dep["relations"])]
            if fault != "no_exchange" and rel:
                tree = _tree(paths, P)
                flat = gossip.flatten(tree, t["block"])
                gossip.unflatten_into(tree, gossip.mix_rows(flat, rel, t["block"], levels))
                del flat
        out.change = {k: (x - p0[k].unsqueeze(0)).reshape(n, -1).double().norm(dim=1).cpu().numpy()
                      for k, x in zip(paths, P)}
        out.grad = {k: grad[j] for j, k in enumerate(paths)}
    return out


def leaf_gap(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
             keep: Optional[Dict[str, np.ndarray]] = None) -> float:
    """Worst gap between two readings of per-(leaf, node) norms: |got - want|
    against the larger of want and the median leaf's want at that node.
    ``keep`` masks out (leaf, node) pairs."""
    keys = sorted(want)
    W = np.stack([want[k] for k in keys])              # (leaves, nodes)
    G = np.stack([got[k] for k in keys])
    med = np.median(W, axis=0)
    gap = np.abs(G - W) / np.maximum(W, med)
    if keep is not None:
        gap = np.where(np.stack([keep[k] for k in keys]), gap, 0.0)
    return float(np.nan_to_num(gap, nan=np.inf).max())


def moving(ref: Readings, floor: float = 1e-3) -> Dict[str, np.ndarray]:
    """The (leaf, node) pairs whose first gradient in the reference is at
    least ``floor`` of the median leaf's; the others move by round-off
    alone under Adam and are left out of the change."""
    keys = sorted(ref.grad)
    med = np.median(np.stack([ref.grad[k] for k in keys]), axis=0)
    return {k: ref.grad[k] >= floor * med for k in keys}


def gaps(got: Readings, ref: Readings) -> Dict[str, float]:
    """The numbers compared: round 1's relative loss gap (its local steps,
    before any exchange: steady from seed to seed, where the later rounds'
    losses swing with bf16's drift), the worst leaf's first-moment gap after
    round 1, the worst moving leaf's change gap after the last checked
    round."""
    loss = abs(got.losses[0] - ref.losses[0]) / abs(ref.losses[0])
    if len(got.losses) != len(ref.losses):
        loss = float("inf")
    return {"first_loss_gap": float(loss),
            "first_moment_gap": leaf_gap(got.mu, ref.mu),
            "change_gap": leaf_gap(got.change, ref.change, moving(ref))}
