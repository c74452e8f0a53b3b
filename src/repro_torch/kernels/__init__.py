"""Hand-written CUDA kernels and their plain PyTorch versions.

Each kernel package's ``ops`` dispatches with :func:`use_ref`: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel (which raises on
anything it does not take; there is no fallback). ``impl="ref"`` forces the
plain version on any device (the yardstick on the card); ``impl="cuda"``
forces the kernel.
"""

IMPLS = ("auto", "cuda", "ref")


def use_ref(t, impl: str = "auto") -> bool:
    """Whether ``impl`` sends tensor ``t`` to the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return t.device.type == "cpu"
    return impl == "ref"
