"""Step-function builders for one card: training (with microbatch gradient
accumulation), prefill and decode.

Counterpart of the JAX package's ``launch/steps.py`` without the mesh: the
port runs on one card, so the ``*_specs`` and ``*_shardings`` functions
have no counterpart. The train step updates the state in place, as the
reference's jit donates it (``donate_argnums=(0,)``), and returns it.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import adamw
from repro_torch.pytree import tree_flatten, tree_unflatten


def init_state(seed: int, cfg: ModelConfig, opt_cfg: adamw.OptConfig, device=None):
    """``{"params", "opt", "step"}``: random params drawn from a generator
    seeded with ``seed`` on ``device`` (the card unless asked otherwise),
    zero moments, step 0."""
    dev = resolve_device(device)
    params = registry.bundle(cfg).init(torch.Generator(device=dev).manual_seed(seed))
    opt = adamw.init_opt_state(params, opt_cfg)
    return {"params": params, "opt": opt, "step": torch.zeros((), dtype=torch.int32,
                                                              device=dev)}


class _OnMeta(TorchFunctionMode):
    """Every tensor a call makes lands on the meta device, whatever device
    it names: shapes and dtypes without memory (draws on meta tensors are
    no-ops)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "device" in kwargs:
            kwargs = {**kwargs, "device": torch.device("meta")}
        return func(*args, **kwargs)


def state_target(cfg: ModelConfig, opt_cfg: adamw.OptConfig):
    """:func:`init_state`'s tree as meta tensors: its structure, shapes and
    dtypes, with no memory taken and nothing drawn (the reference's
    ``state_specs``). A restore's target."""
    with _OnMeta():
        return init_state(0, cfg, opt_cfg, "cpu")


def build_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                     impl: str = "auto") -> Callable:
    """``(state, batch) -> (state, metrics)``: the gradient of the model's
    loss over the global batch, in ``cfg.micro_steps`` microbatches (the
    batch's rows split in order) whose float32 gradients are summed and
    divided by their count, as are their losses; the other metrics are the
    mean over microbatches. Then one AdamW step, written into the state.
    ``impl="ref"`` runs attention's plain versions (the card's yardstick)."""
    b = registry.bundle(cfg)
    micro = max(cfg.micro_steps, 1)

    def grad_of(leaves, treedef, mb):
        loss, metrics = b.loss_fn(tree_unflatten(treedef, leaves), mb, impl)
        return loss.detach(), metrics, list(torch.autograd.grad(loss, leaves))

    def train_step(state, batch: Dict[str, torch.Tensor]):
        flat, treedef = tree_flatten(state["params"])
        leaves = [t.detach().requires_grad_(True) for t in flat]
        if micro == 1:
            loss, metrics, grads = grad_of(leaves, treedef, batch)
        else:
            mbatches = {k: v.reshape((micro, v.shape[0] // micro) + tuple(v.shape[1:]))
                        for k, v in batch.items()}
            grads = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                     for t in flat]
            loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            seen = []
            for i in range(micro):
                l, m, g = grad_of(leaves, treedef, {k: v[i] for k, v in mbatches.items()})
                for acc, x in zip(grads, g):
                    acc.add_(x.to(torch.float32))
                del g
                loss = loss + l
                seen.append({k: v.detach() for k, v in m.items()})
            grads = [g / micro for g in grads]
            loss = loss / micro
            metrics = {k: torch.stack([m[k] for m in seen]).mean() for k in seen[0]}
        del leaves
        with torch.no_grad():
            opt_metrics = adamw.apply_updates_(state["params"], grads, state["opt"], opt_cfg)
            state["step"].add_(1)
        metrics = {"loss": loss, **{k: v.detach() for k, v in metrics.items()},
                   **opt_metrics}
        return state, metrics

    return train_step


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig) -> Callable:
    b = registry.bundle(cfg)

    def prefill_step(params, batch):
        with torch.no_grad():
            return b.prefill_fn(params, batch, shape.seq_len)

    return prefill_step


def build_decode_step(cfg: ModelConfig) -> Callable:
    b = registry.bundle(cfg)

    def serve_step(params, cache, batch):
        with torch.no_grad():
            return b.decode_fn(params, cache, batch)

    return serve_step

