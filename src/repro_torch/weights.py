"""Move params and FL state between the JAX reference and the port.

The reference's trees come in as numpy arrays (``np.asarray`` of each leaf)
in the same nested-dict layout the port uses; bfloat16 leaves arrive as
numpy arrays of the ``bfloat16`` extension dtype. NamedTuples of fields
``(q, scale)`` (int8 moments) become the port's
:class:`repro_torch.optim.adamw.QTensor`; any other NamedTuple (a decode
cache's ``KVCache`` or ``MambaCache``) converts field by field and keeps its
type. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim.adamw import QTensor


def _is_qtensor(x) -> bool:
    return isinstance(x, tuple) and getattr(x, "_fields", None) == ("q", "scale")


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(tree: Any, device) -> Any:
    if _is_qtensor(tree):
        return QTensor(q=_to_tensor(tree[0], device), scale=_to_tensor(tree[1], device))
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_convert(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, device) for v in tree)
    if tree is None:
        return None
    return _to_tensor(tree, device)


def params_from_jax(tree_of_numpy: Any, device=None) -> Any:
    """Reference params (numpy leaves) -> the port's tensors on ``device``."""
    return _convert(tree_of_numpy, resolve_device(device))


def state_from_jax(state_of_numpy: Any, device=None) -> Any:
    """A reference train state ({"params", "opt": {"mu", "nu", "count"},
    "step"}, numpy leaves: ``launch/steps.init_state``'s, or
    ``_stack_init``'s with the node axis first) -> the port's state on
    ``device``."""
    return _convert(state_of_numpy, resolve_device(device))


def to_numpy(tree: Any) -> Any:
    """The port's tensors -> numpy (bfloat16 as float32), same layout."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree
