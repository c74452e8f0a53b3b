"""PyTorch + CUDA port of the TDM-FLA system, for one NVIDIA H100.

Counterpart of the JAX package ``repro``, which stays the reference. The port
imports torch and numpy only. FL nodes are stacked on a leading tensor axis
instead of one node per device, and each Pallas TPU kernel on a ported path
has a CUDA kernel for ``sm_90a`` (``csrc/``) beside a plain PyTorch version.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
