"""Hand-written CUDA kernels and their plain PyTorch versions.

Each kernel package's ``ops`` dispatches with :func:`use_ref`: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel (which raises on
anything it does not take; there is no fallback). ``impl="ref"`` forces the
plain version on any device (the yardstick on the card); ``impl="cuda"``
forces the kernel.

Each kernel wrapper module keeps a ``LAUNCHES`` dict, one counter per kernel
it launches (a graph replay counts what its capture recorded);
:func:`launch_counts`, :func:`reset_launch_counts` and
:func:`add_launch_counts` read and write all of them by kernel name.
"""

import functools
import importlib
from typing import Dict, Tuple

IMPLS = ("auto", "cuda", "ref")
# the wrapper modules that count launches; imported on first use, since each
# imports ``kernels.build``, a submodule of this package
_COUNTED = ("repro_torch.kernels.tdm_compress.tdm_compress",
            "repro_torch.kernels.ssd_scan.ssd_scan",
            "repro_torch.kernels.flash_attention.flash_attention")


def use_ref(t, impl: str = "auto") -> bool:
    """Whether ``impl`` sends tensor ``t`` to the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return t.device.type == "cpu"
    return impl == "ref"


@functools.lru_cache(maxsize=None)
def _counters() -> Tuple[Dict[str, int], ...]:
    return tuple(importlib.import_module(name).LAUNCHES for name in _COUNTED)


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count, by kernel name."""
    return {kernel: n for counts in _counters() for kernel, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _counters():
        for kernel in counts:
            counts[kernel] = 0


def add_launch_counts(added: Dict[str, int]) -> None:
    """Add ``added[kernel]`` to each named kernel's count (negative to take
    launches back out)."""
    for counts in _counters():
        for kernel in counts.keys() & added.keys():
            counts[kernel] += added[kernel]
