"""Deterministic synthetic LM data pipeline, host-sharded.

Every batch is a pure function of (seed, step, shard) — no state, no I/O —
so restarts/elastic rescale reproduce the exact token stream (checkpointed
``step`` is all you need). The token process is a noisy affine walk over the
vocab, giving a learnable structure (loss decreases under training) while
staying trivially cheap to generate.

Copied from the JAX package's ``data/pipeline.py`` (numpy only), so both
packages draw the same tokens; ``global_batch`` (a JAX device-array builder)
is left out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.models.config import ModelConfig, ShapeConfig


def _rng_for(seed: int, step: int, row: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(step, row))
    )


def synth_tokens(vocab: int, seq: int, rng: np.random.Generator) -> np.ndarray:
    """Noisy affine token walk: x_{t+1} = (a x_t + b + eps) mod V."""
    a = int(rng.integers(3, 17)) | 1
    b = int(rng.integers(0, vocab))
    x = np.empty(seq + 1, dtype=np.int64)
    x[0] = rng.integers(0, vocab)
    noise = rng.integers(0, 3, size=seq)
    for t in range(seq):
        x[t + 1] = (a * x[t] + b + noise[t]) % vocab
    return x


def host_batch(
    cfg: ModelConfig,
    shape: ShapeConfig,
    step: int,
    seed: int = 0,
    rows: Optional[range] = None,
) -> Dict[str, np.ndarray]:
    """Materialize (a slice of) the global batch for one host."""
    B, S = shape.global_batch, shape.seq_len
    rows = rows if rows is not None else range(B)
    toks = np.empty((len(rows), S + 1), dtype=np.int32)
    for i, r in enumerate(rows):
        toks[i] = synth_tokens(cfg.vocab_size, S, _rng_for(seed, step, r))
    batch: Dict[str, np.ndarray] = {
        "tokens": toks[:, :S],
        "labels": toks[:, 1:],
    }
    if cfg.mrope_sections is not None:
        pos = np.broadcast_to(np.arange(S)[None, :, None], (len(rows), S, 3))
        batch["positions"] = np.ascontiguousarray(pos, dtype=np.int32)
    if cfg.enc_dec:
        rng = _rng_for(seed, step, 10_000_000)
        batch["enc_embeds"] = rng.standard_normal(
            (len(rows), cfg.enc_frames, cfg.d_model), dtype=np.float32
        )
    return batch


@dataclasses.dataclass
class SyntheticStream:
    """Stateless iterator facade used by launch/train.py."""

    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        return host_batch(self.cfg, self.shape, step, self.seed)
