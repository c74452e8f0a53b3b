"""Model + shape configuration for the assigned architecture pool.

One :class:`ModelConfig` describes any member of the LM family used here:
dense transformer (gemma2/granite/qwen2/qwen2-vl), pure SSM (mamba2), hybrid
(jamba), MoE (qwen3-moe/kimi-k2), encoder–decoder (whisper), and a stack
driven by a per-layer pattern (nemotron-3-nano: Mamba-2, MoE and attention
layers in one irregular order, ``pattern``). The config
is pure data — the model code in :mod:`repro_torch.models.transformer` interprets
it; the launch layer lowers it for a mesh.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                 # per-expert hidden dim
    every: int = 1            # a FFN is MoE iff (layer_idx % every == every - 1)
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2
    # nemotron-h: a sigmoid router with a selection-only bias, every
    # assignment computed (no capacity), experts of the config's MLP form
    dropless: bool = False
    routed_scale: float = 1.0       # the routed weights' factor after renormalising
    shared_d_ff: int = 0            # one always-on shared expert of this width (0: none)


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64        # SSD head dim (P)
    n_groups: int = 1
    chunk: int = 256          # SSD chunk length (MXU-aligned)
    dt_min: float = 0.001
    dt_max: float = 0.1
    heads: int = 0            # >0: d_inner = heads * head_dim (not expand * d_model)
    norm_per_group: bool = False  # gated norm over each group's d_inner / n_groups

    def d_inner(self, d_model: int) -> int:
        if self.heads:
            return self.heads * self.head_dim
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention flavor
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None    # window size for local layers
    local_global_alternate: bool = False    # gemma2: even layers local
    force_local: bool = False               # every attn layer windowed (jamba
                                            # long-context serving config)
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    rope: bool = True                       # False: no positional rotation (NoPE)

    # mixer pattern (hybrid / ssm)
    attn_every: Optional[int] = None        # jamba: 8 => layer i is attn iff i%8==0
    attn_free: bool = False                 # mamba2: no attention layers at all
    mamba: Optional[MambaConfig] = None
    # one layer per character, repeated over the stack: M mamba, * attention,
    # E MoE, - dense MLP; each layer one pre-norm block (nemotron-h)
    pattern: Optional[str] = None

    # ffn flavor
    moe: Optional[MoEConfig] = None
    act: str = "silu"                       # silu | gelu
    gated_mlp: bool = True                  # False: 2-mat GPT-style MLP
    no_ffn: bool = False                    # mamba2: mixer-only blocks

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500                  # stub frontend output length

    # embedding / head
    tie_embeddings: bool = True
    embed_scale: bool = False               # gemma2: h *= sqrt(d_model)
    norm_eps: float = 1e-6

    # numerics / execution
    param_dtype: str = "float32"            # float32 | bfloat16
    compute_dtype: str = "bfloat16"
    remat: str = "full"                     # none | full
    scan_layers: bool = True
    use_pallas: bool = False                # TPU: swap in Pallas kernels
    attn_block_q: int = 512
    attn_block_k: int = 1024
    loss_chunk: int = 1024                  # vocab-projection seq chunking

    # distribution knobs (interpreted by launch/sharding.py)
    fsdp: bool = False                      # legacy alias: parallel_mode fsdp
    parallel_mode: Optional[str] = None     # tp | fsdp | fsdp_pure | tp2d
    serve_parallel_mode: str = "tp"         # prefill/decode sharding mode
    opt_dtype: str = "float32"              # float32 | bfloat16 | int8
    micro_steps: int = 1                    # gradient-accumulation steps
    pp_stages: int = 0                      # >0: pipeline-parallel training
    pp_micro: int = 0                       # PP microbatches (0 -> 4*stages)

    @property
    def train_mode(self) -> str:
        if self.parallel_mode is not None:
            return self.parallel_mode
        return "fsdp" if self.fsdp else "tp"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------- pattern
    def layer_kind(self, i: int) -> str:
        """The ``pattern`` character of layer ``i``."""
        return self.pattern[i % len(self.pattern)]

    def layer_is_attn(self, i: int) -> bool:
        if self.pattern is not None:
            return self.layer_kind(i) == "*"
        if self.attn_free:
            return False
        if self.attn_every is not None:
            return i % self.attn_every == 0
        return True

    def layer_is_local(self, i: int) -> bool:
        """gemma2 alternation: even layers use the sliding window."""
        return bool(self.local_global_alternate and i % 2 == 0)

    def ffn_is_moe(self, i: int) -> bool:
        if self.pattern is not None:
            return self.layer_kind(i) == "E"
        return self.moe is not None and (i % self.moe.every == self.moe.every - 1)

    # -------------------------------------------------------------- counts
    def param_count(self) -> int:
        """Exact parameter count (used for 6ND model-FLOPs roofline)."""
        D, V = self.d_model, self.vocab_size
        total = V * D  # embedding
        if not self.tie_embeddings:
            total += V * D
        total += D  # final norm
        layers = range(self.n_layers)
        for i in layers:
            total += self._block_params(i)
        if self.enc_dec:
            for i in range(self.n_enc_layers):
                total += self._enc_block_params()
            total += D  # encoder final norm
        return total

    def _attn_params(self, cross: bool = False) -> int:
        D, H, KV, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        n = D * H * hd + 2 * D * KV * hd + H * hd * D
        if self.qkv_bias:
            n += H * hd + 2 * KV * hd
        return n

    def _mlp_params(self, d_ff: int) -> int:
        return (3 if self.gated_mlp else 2) * self.d_model * d_ff

    def _moe_params(self) -> int:
        m = self.moe
        n = self.d_model * m.n_experts + m.n_experts * self._mlp_params(m.d_ff)
        if m.dropless:
            n += m.n_experts                 # the selection bias
        if m.shared_d_ff:
            n += self._mlp_params(m.shared_d_ff)
        return n

    def _mamba_params(self) -> int:
        mb, D = self.mamba, self.d_model
        di = mb.d_inner(D)
        hm = mb.n_heads(D)
        conv_dim = di + 2 * mb.n_groups * mb.d_state
        n = D * di * 2                      # wx, wz
        n += 2 * D * mb.n_groups * mb.d_state  # wB, wC
        n += D * hm                          # wdt
        n += mb.d_conv * conv_dim + conv_dim  # conv w + b
        n += 3 * hm                          # A_log, D_skip, dt_bias
        n += di                              # gated norm
        n += di * D                          # out_proj
        return n

    def _block_params(self, i: int) -> int:
        D = self.d_model
        if self.pattern is not None:
            kind = self.layer_kind(i)
            body = {"M": self._mamba_params, "*": self._attn_params, "E": self._moe_params,
                    "-": lambda: self._mlp_params(self.d_ff)}[kind]
            return body() + D
        n = 0
        if self.layer_is_attn(i):
            n += self._attn_params() + D  # + ln
            if self.enc_dec:
                n += self._attn_params() + D  # cross-attention + ln
        elif self.mamba is not None:
            n += self._mamba_params() + D
        if not self.no_ffn:
            if self.ffn_is_moe(i):
                n += self._moe_params() + D
            else:
                n += self._mlp_params(self.d_ff) + D
        return n

    def _enc_block_params(self) -> int:
        return self._attn_params() + self.d_model + self._mlp_params(self.d_ff) + self.d_model

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        m = self.moe
        n_moe_layers = sum(1 for i in range(self.n_layers) if self.ffn_is_moe(i))
        inactive_frac = (m.n_experts - m.top_k) / m.n_experts
        inactive = int(n_moe_layers * m.n_experts * self._mlp_params(m.d_ff) * inactive_frac)
        return total - inactive


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what gets lowered and with which step fn."""

    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
