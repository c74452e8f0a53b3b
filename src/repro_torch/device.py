"""Device selection for the port's entry points.

Entry points default to the card. They run on the CPU only when the caller
asks for it (``device="cpu"``, as the tests do); without a card and without
that request they raise instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU (plain PyTorch versions of the kernels)"
        )
    return dev
