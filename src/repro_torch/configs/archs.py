"""The 10 assigned architectures as exact configs, plus reduced smoke
variants of each family, and nemotron-3-nano-30b-a3b (the port's own: it has
no counterpart in the JAX package).

Sources as assigned (``[source; tier]`` from the task sheet). Head dims use
the published values where the d_model/n_heads quotient differs from the
real model (gemma2-9b: 256, gemma2-27b: 128, qwen3-moe: 128 — q/o projections
are rectangular, exactly as in the HF checkpoints).

Per-arch distribution defaults (fsdp / opt_dtype / micro_steps) encode what
the roofline requires at 256–512 chips; they are hillclimb levers in §Perf.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig, ShapeConfig, SHAPES

ARCHS: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# --- mamba2-780m [ssm] 48L d=1536 attn-free vocab=50280 ssm_state=128 --------
# SSD (state-space duality) [arXiv:2405.21060]
MAMBA2_780M = _register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0, n_kv_heads=0, head_dim=0,   # attention-free
    d_ff=0,
    no_ffn=True,
    attn_free=True,
    vocab_size=50_280,
    mamba=MambaConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
    tie_embeddings=True,
    # §Perf: 780M params on 256 chips drown in TP all-reduces; pure ZeRO-3
    # (batch over the whole mesh) makes per-layer traffic = weight gathers
    parallel_mode="fsdp_pure",
))

# --- gemma2-9b [dense] 42L d=3584 16H (GQA kv=8) ff=14336 vocab=256000 -------
# local+global alternating, logit softcap [arXiv:2408.00118]
GEMMA2_9B = _register(ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14_336,
    vocab_size=256_000,
    local_global_alternate=True,
    sliding_window=4_096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    # §Perf iteration 4: fsdp_pure lifted this cell 8.6% -> 27.3% MFU
    parallel_mode="fsdp_pure",
))

# --- gemma2-27b [dense] 46L d=4608 32H (GQA kv=16) ff=36864 vocab=256000 -----
GEMMA2_27B = _register(ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36_864,
    vocab_size=256_000,
    local_global_alternate=True,
    sliding_window=4_096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
))

# --- granite-20b [dense] 52L d=6144 48H (GQA kv=1 = MQA) ff=24576 ------------
# llama-arch, code [arXiv:2405.04324]
GRANITE_20B = _register(ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    gated_mlp=False,       # GPT-BigCode lineage: 2-matrix MLP
    act="gelu",
    tie_embeddings=True,
))

# --- qwen2-72b [dense] 80L d=8192 64H (GQA kv=8) ff=29568 vocab=152064 -------
# GQA + QKV bias [arXiv:2407.10671]
QWEN2_72B = _register(ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29_568,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    fsdp=True,
    micro_steps=4,
))

# --- jamba-1.5-large-398b [hybrid] 72L d=8192 64H (GQA kv=8) ff=24576 --------
# Mamba+attn 1:7, MoE 16e top-2 every other layer [arXiv:2403.19887]
JAMBA_1_5_LARGE = _register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    attn_every=8,
    mamba=MambaConfig(d_state=128, head_dim=64, expand=2, n_groups=8),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=24_576, every=2),
    tie_embeddings=True,
    fsdp=True,
    micro_steps=4,
    # serving: 398B params exceed TP-16 HBM; stationary 2D expert shard
    serve_parallel_mode="tp2d",
))

# --- qwen3-moe-30b-a3b [moe] 48L d=2048 32H (GQA kv=4) ff=768 128e top-8 -----
# [hf:Qwen/Qwen3-30B-A3B]
QWEN3_MOE_30B = _register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=6144,                       # dense-equivalent (unused: all-MoE)
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768, every=1),
    tie_embeddings=True,
))

# --- kimi-k2-1t-a32b [moe] 61L d=7168 64H (GQA kv=8) ff=2048 384e top-8 ------
# trillion-param MoE [arXiv:2501.kimi2 paper-table]
KIMI_K2_1T = _register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=22_528,                     # dense-equivalent (unused: all-MoE)
    vocab_size=163_840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, every=1),
    tie_embeddings=False,
    fsdp=True,
    param_dtype="bfloat16",
    opt_dtype="int8",
    micro_steps=8,
    # §Perf iteration 3: pipeline parallelism (PP16xTP16, 64 microbatches)
    # replaced FSDP gather-per-microbatch: collective 196s -> 63s/step.
    pp_stages=16,
    pp_micro=64,
    # §Perf iteration 5: serving keeps experts stationary (E x F 2D shard;
    # fits 9.2 GB/device) instead of FSDP gather-per-token
    serve_parallel_mode="tp2d",
))

# --- whisper-base [audio] 6L(+6 enc) d=512 8H ff=2048 vocab=51865 ------------
# enc-dec, conv frontend STUB [arXiv:2212.04356]
WHISPER_BASE = _register(ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    enc_dec=True,
    n_enc_layers=6,
    enc_frames=1536,       # whisper's 1500, padded to the 512-block tiling
    act="gelu",
    tie_embeddings=True,
    attn_block_q=512,
    attn_block_k=512,
))

# --- qwen2-vl-72b [vlm] 80L d=8192 64H (GQA kv=8) ff=29568 -------------------
# M-RoPE, dynamic resolution; patch frontend STUB [arXiv:2409.12191]
QWEN2_VL_72B = _register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29_568,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),     # t/h/w frequency pairs (sum = hd/2)
    tie_embeddings=False,
    fsdp=True,
    micro_steps=4,
))

# --- nemotron-3-nano-30b-a3b [hybrid] 52L d=2688 32H (GQA kv=2) 128e top-6 ---
# [hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16 config.json, model_type
# nemotron_h]: 23 Mamba-2 (64 heads x 64 in 8 groups, per-group gated norm),
# 23 MoE (sigmoid router with a selection bias, top-6 renormalised x 2.5,
# relu^2 experts of 1856 and one shared expert of 3712, dropless) and 6
# attention layers (no rope) in one pattern; untied head; bf16 params.
NEMOTRON_H_PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"
NEMOTRON_3_NANO = _register(ModelConfig(
    name="nemotron-3-nano-30b-a3b",
    family="hybrid",
    n_layers=52,
    d_model=2688,
    n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=1856,
    vocab_size=131_072,
    pattern=NEMOTRON_H_PATTERN,
    rope=False,
    mamba=MambaConfig(d_state=128, d_conv=4, head_dim=64, n_groups=8, chunk=128,
                      heads=64, norm_per_group=True),
    moe=MoEConfig(n_experts=128, top_k=6, d_ff=1856, dropless=True, routed_scale=2.5,
                  shared_d_ff=3712),
    act="relu2",
    gated_mlp=False,
    tie_embeddings=False,
    norm_eps=1e-5,
    param_dtype="bfloat16",
))


# ---------------------------------------------------------------------------
# per-(arch, shape) config adjustments + cell validity
# ---------------------------------------------------------------------------

def long_context_applicable(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic families (DESIGN.md §5)."""
    return cfg.family in ("ssm", "hybrid")


def decode_applicable(cfg: ModelConfig) -> bool:
    return True  # all assigned archs are decoders (whisper via its decoder)


def cfg_for_cell(cfg: ModelConfig, shape: ShapeConfig) -> Optional[ModelConfig]:
    """Shape-specialized config, or None if the cell is skipped."""
    if shape.name == "long_500k":
        if not long_context_applicable(cfg):
            return None
        if cfg.family == "hybrid":
            # Jamba long-context serving: windowed attention layers (the
            # arch's effective-context design), mamba layers carry state.
            cfg = cfg.replace(force_local=True, sliding_window=4_096)
    if shape.kind == "train":
        # microbatching only matters for training cells
        return cfg
    return cfg.replace(micro_steps=1)


def smoke_cfg(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: tiny widths, few layers/experts, small
    vocab — used by per-arch CPU smoke tests. A pattern config keeps the
    first layer of each kind its pattern has, in order (nemotron-h: ``ME*``)."""
    if cfg.pattern is not None:
        cfg = cfg.replace(pattern="".join(dict.fromkeys(cfg.pattern)))
    kw = dict(
        n_layers=len_scan_unit(cfg) * 2,
        d_model=64,
        vocab_size=128,
        norm_eps=1e-6,
        attn_block_q=8,
        attn_block_k=8,
        loss_chunk=16,
        micro_steps=1,
        enc_frames=12 if cfg.enc_dec else cfg.enc_frames,
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), head_dim=16)
        if cfg.mrope_sections is not None:
            half = 16 // 2  # smoke head_dim = 16
            t = half // 4
            h = (half - t) // 2
            kw.update(mrope_sections=(t, h, half - t - h))
    if cfg.d_ff:
        kw.update(d_ff=96)
    if cfg.moe is not None and cfg.moe.dropless:
        kw.update(moe=dataclasses.replace(
            cfg.moe, n_experts=16, top_k=4, d_ff=32,
            shared_d_ff=48 if cfg.moe.shared_d_ff else 0))
    elif cfg.moe is not None:
        kw.update(moe=MoEConfig(
            n_experts=4, top_k=2, d_ff=32, every=cfg.moe.every,
            capacity_factor=4.0,   # generous: smoke tests assume no drops
        ))
    if cfg.mamba is not None:
        kw.update(mamba=MambaConfig(
            d_state=16, head_dim=8, expand=2,
            n_groups=min(cfg.mamba.n_groups, 2), chunk=8,
            # explicit heads: 6 x 8 = 48 channels, not expand * d_model
            heads=6 if cfg.mamba.heads else 0,
            norm_per_group=cfg.mamba.norm_per_group,
        ))
    if cfg.sliding_window is not None:
        kw.update(sliding_window=16)
    return cfg.replace(**kw)


def len_scan_unit(cfg: ModelConfig) -> int:
    from repro_torch.models.transformer import scan_unit

    return len(scan_unit(cfg))


def get(name: str) -> ModelConfig:
    return ARCHS[name]


def all_cells():
    """Yield every valid (arch cfg, shape) cell — 40 minus inapplicable."""
    for name, cfg in ARCHS.items():
        for shape in SHAPES.values():
            c = cfg_for_cell(cfg, shape)
            if c is not None:
                yield name, shape.name, c, shape
