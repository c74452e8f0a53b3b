"""The yardstick's arithmetic: the H100's peaks, and the operations and bytes
of the work the cells time, computed from the configuration's shapes alone.

Nothing here reads the program. A configuration's own file
(``configs/<name>.py``) binds these formulas to its sizes.
"""

from __future__ import annotations

import dataclasses
import math

# NVIDIA H100 SXM data sheet, dense rates, at its full 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def padded(n: int, block: int) -> int:
    return -(-int(n) // int(block)) * int(block)


@dataclasses.dataclass(frozen=True)
class Mamba2:
    """Shapes of a Mamba-2 language model (the published block: in
    projections to z, x, B, C and dt, a depthwise causal conv over x, B and
    C, the SSD scan, a gated RMSNorm and the out projection; tied
    embeddings)."""

    d_model: int
    n_layer: int
    vocab_size: int
    d_state: int
    d_conv: int
    expand: int
    headdim: int
    ngroups: int
    chunk_size: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Mamba2":
        s = cfg["ssm_cfg"]
        return cls(cfg["d_model"], cfg["n_layer"], cfg["vocab_size"], s["d_state"],
                   s["d_conv"], s["expand"], s["headdim"], s["ngroups"], s["chunk_size"])

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ngroups * self.d_state

    # -- parameters ------------------------------------------------------
    def layer_matmul_params(self) -> int:
        """Weights a token meets in one layer's products: in projections
        (z, x, B, C, dt) and the out projection."""
        D, di, GN = self.d_model, self.d_inner, self.ngroups * self.d_state
        return 2 * D * di + 2 * D * GN + D * self.n_heads + di * D

    def layer_params(self) -> int:
        """Every parameter of one layer: its products, the conv's taps and
        biases, A, D and the dt bias per head, the gated norm, the pre-norm."""
        return (self.layer_matmul_params() + self.d_conv * self.conv_dim + self.conv_dim
                + 3 * self.n_heads + self.d_inner + self.d_model)

    def params(self) -> int:
        """Per model: tied embedding, the layers, the final norm."""
        return self.vocab_size * self.d_model + self.n_layer * self.layer_params() + self.d_model

    # -- operations per token --------------------------------------------
    def ssd_chunked_flops(self) -> float:
        """One token's share of the chunked SSD scan in one layer: C.B within
        its chunk (per group) and the weighted sum of x (per head), both over
        the causal half of the chunk, plus its term of the chunk state and its
        read of the carried state (per head)."""
        Q, N, P = self.chunk_size, self.d_state, self.headdim
        pairs = (Q + 1) / 2
        return (self.ngroups * 2 * N * pairs + self.n_heads * 2 * P * pairs
                + self.n_heads * 4 * N * P)

    def ssd_recurrent_flops(self) -> float:
        """One decode step of the SSD in one layer: the state's update and its
        read, per head."""
        return self.n_heads * 4 * self.d_state * self.headdim

    def conv_flops(self) -> float:
        return 2 * self.d_conv * self.conv_dim

    def layer_flops(self, recurrent: bool) -> float:
        ssd = self.ssd_recurrent_flops() if recurrent else self.ssd_chunked_flops()
        return 2 * self.layer_matmul_params() + self.conv_flops() + ssd

    def head_flops(self) -> float:
        return 2 * self.d_model * self.vocab_size

    def train_flops_per_token(self) -> float:
        """Forward and backward (three forwards' worth) of one training
        token; recomputation is not counted."""
        return 3 * (self.n_layer * self.layer_flops(False) + self.head_flops())

    def prompt_flops_per_token(self) -> float:
        """A prompt token through every layer; the head only runs for the
        tokens that are generated."""
        return self.n_layer * self.layer_flops(False)

    def generated_flops(self, from_decode: bool) -> float:
        """One generated token: its head, plus a decode step through every
        layer for the tokens after a request's first (which comes out of the
        prefill's last position)."""
        layers = self.n_layer * self.layer_flops(True) if from_decode else 0.0
        return layers + self.head_flops()


# -- bytes of the int8 exchange -------------------------------------------

def quantize_bytes(rows: int, n: int, block: int) -> int:
    """x read once (f32), codes written once (int8), one f32 scale a block."""
    return rows * n * (4 + 1) + rows * math.ceil(n / block) * 4


def dequant_accumulate_bytes(rows: int, n: int, block: int) -> int:
    """Codes (int8) and accumulator (f32) read once, the accumulator written
    once, one f32 scale a block and one f32 weight a row read."""
    return rows * n * (1 + 4 + 4) + rows * math.ceil(n / block) * 4 + rows * 4


def mix_least_bytes(rows: int, n: int) -> int:
    """The least any implementation of one mix moves: the stacked f32
    params read once and the mixed result written once."""
    return 2 * rows * n * 4


def seconds_at_hbm(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
