"""The LM decoder stack, every family of the configs: ssm (mamba2), dense
(gemma2, granite, qwen2, qwen2-vl), moe (qwen3-moe, kimi-k2), hybrid
(jamba) and encoder-decoder (whisper): init, prefill and decode, training
forward and loss.

Counterpart of the JAX package's ``models/transformer.py``. A config is
compiled to a list of :class:`LayerDesc` per *scan unit*:

- ssm (mamba2):                    unit = [mamba],               L units
- dense (granite/qwen2/qwen2-vl):  unit = [attn+mlp],            L units
- gemma2:                          unit = [attn(local)+mlp,
                                           attn(global)+mlp],    L/2 units
- moe (qwen3-moe/kimi-k2):         unit = [attn+moe],            L units
- hybrid (jamba):                  unit = [attn+mlp, (mamba+moe, mamba+mlp)
                                           alternating x7],      L/8 units
- whisper decoder:                 unit = [attn+cross+mlp],      L units
- pattern (nemotron-h):            unit = one layer per character of
                                   ``cfg.pattern``: M [mamba], * [attn],
                                   E [moe], - [mlp],             L/len units

A pattern layer is one pre-norm block ``h + sub(RMSNorm(h))`` with a mixer
and no FFN (M, *) or an FFN and no mixer (E, -); its one norm is ``ln``.
Its attention takes no rope under ``cfg.rope = False`` (NoPE). Each MoE
layer of a prefill or decode call is a ``model.moe`` device span (routing,
experts, shared expert and combine).

Units are stacked on a leading layer axis as in the reference (its
``lax.scan`` layout), and the forward loops over them. The hybrid unit is
the reference's as it computes it: Mamba-2 layers, rope on the attention
layer, every attention layer windowed under ``force_local`` (jamba's
long-context serving config).

Encoder-decoder (whisper): :func:`encoder_forward` runs the bidirectional
encoder over the stub frame embeddings ``enc_embeds`` (B, F, D) (rope at
``arange(F)``, non-causal self-attention through ``flash_attention_train``,
each block checkpointed under ``remat == "full"``), and every decoder layer
adds a cross-attention sub-layer against the encoder output's K/V (no rope,
no mask: Sq decoder tokens against Skv = F frames). Its prefill keeps that
K/V as the frozen ``cross{j}`` cache, which decode attends through
``flash_attention_decode`` with every frame valid (the cache's ``enc_len``,
the frame count of each lane, made once per cache). A prefill or loss of an
encoder-decoder config without ``enc_embeds`` raises (the reference
asserts). M-RoPE (qwen2-vl): positions are (B, S, 3), one stream per
(temporal, height, width) component (:func:`~repro_torch.models.layers.apply_mrope`);
without explicit positions they are the text positions on all three, as in
the reference.
Training: with ``cfg.remat == "full"`` (the default) each unit of
:func:`forward_train` runs under ``torch.utils.checkpoint`` (recomputed in
the backward, as the reference's ``jax.checkpoint`` of the scan body), and
:func:`loss_fn` checkpoints each ``loss_chunk`` of the vocab projection, so
a step keeps one chunk's float32 logits at a time. Neither changes a value.
The MoE layers' aux losses (:func:`~repro_torch.models.moe.moe_apply`) are
summed per unit and over units, as the reference's scan carries them, and
:func:`loss_fn` adds them to the cross-entropy.
Attention trains through :func:`~repro_torch.models.attention.flash_attention_train`
(its manual backward: the CUDA kernels on the card).

Caches (``{"pos", "units"}`` as in the reference): per attention layer a
:class:`KVCache` (length ``max_len``, or the window for local layers: a
ring, slot ``t % L`` holding position t), per cross-attention layer the
encoder's K/V (``enc_frames`` slots), per mamba layer a
:class:`~repro_torch.models.mamba2.MambaCache`, each stacked on the layer
axis. ``pos`` is the number of tokens the cache holds: a scalar, or one value
per replica when a serving decoder folds several replicas' lanes into one
batch (:func:`decode_step` expands it to one value per lane).

Attention runs through :mod:`repro_torch.kernels.flash_attention.ops` and
the SSD scan through :mod:`repro_torch.kernels.ssd_scan.ops`: the CUDA
kernels on the card, their plain versions on the CPU. The prefill's
``impl`` forces one ("auto", "cuda" or "ref").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from repro_torch import telemetry
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import AttnSpec, flash_attention_train
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_mrope,
    apply_rope,
    dtype_of,
    embed_tokens,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    lm_logits,
    mlp_apply,
    rmsnorm,
    truncated_normal,
)
from repro_torch.pytree import tree_map

Params = Dict[str, Any]


@dataclass(frozen=True)
class LayerDesc:
    mixer: Optional[str]        # "attn" | "mamba" | None (a pattern's FFN-only layer)
    local: bool = False         # sliding-window attention
    ffn: Optional[str] = None   # "dense" | "moe" | None
    cross: bool = False         # cross-attention (whisper decoder)


def scan_unit(cfg: ModelConfig) -> List[LayerDesc]:
    """The per-unit layer pattern for this config (see module docstring)."""
    if cfg.pattern is not None:
        kinds = {"M": ("mamba", None), "*": ("attn", None), "E": (None, "moe"),
                 "-": (None, "dense")}
        return [LayerDesc(kinds[c][0], ffn=kinds[c][1]) for c in cfg.pattern]
    if cfg.family == "ssm":
        return [LayerDesc("mamba", ffn=None if cfg.no_ffn else "dense")]
    if cfg.family == "hybrid":
        return [LayerDesc("attn" if j == 0 else "mamba",
                          local=cfg.layer_is_local(j) or cfg.force_local,
                          ffn="moe" if cfg.ffn_is_moe(j) else "dense")
                for j in range(cfg.attn_every)]
    if cfg.local_global_alternate:
        return [LayerDesc("attn", local=True, ffn="moe" if cfg.ffn_is_moe(0) else "dense"),
                LayerDesc("attn", local=False, ffn="moe" if cfg.ffn_is_moe(1) else "dense")]
    ffn = "moe" if (cfg.moe is not None and cfg.moe.every == 1) else "dense"
    return [LayerDesc("attn", local=cfg.force_local, ffn=ffn, cross=cfg.enc_dec)]


def n_units(cfg: ModelConfig) -> int:
    return cfg.n_layers // len(scan_unit(cfg))


# ---------------------------------------------------------------------------
# attention sub-layer
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = dtype_of(cfg.param_dtype)
    std = D ** -0.5
    p = {
        "wq": truncated_normal(gen, (D, H, hd), std, dt),
        "wk": truncated_normal(gen, (D, KV, hd), std, dt),
        "wv": truncated_normal(gen, (D, KV, hd), std, dt),
        "wo": truncated_normal(gen, (H, hd, D), (H * hd) ** -0.5, dt),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros((heads, hd), dtype=dt, device=gen.device)
    return p


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    cdt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cdt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)[None, None]
        k = k + p["bk"].to(cdt)[None, None]
        v = v + p["bv"].to(cdt)[None, None]
    return q, k, v.contiguous()


def _rope_qk(q, k, positions, cfg: ModelConfig):
    if not cfg.rope:
        return q.contiguous(), k.contiguous()
    if cfg.mrope_sections is not None:
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)


def _text_positions(B: int, S: int, cfg: ModelConfig, device, start=None) -> torch.Tensor:
    """Text positions: ``arange(S)`` per lane, or one token per lane at
    ``start`` (B,); (B, S), or (B, S, 3) under M-RoPE (the same value on
    every component)."""
    pos = torch.arange(S, device=device)[None].expand(B, S) if start is None else start[:, None]
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(B, S, 3)
    return pos


def _cross_q(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)[None, None]
    return q


def enc_kv_for_cross(p: Params, enc_out: torch.Tensor, cfg: ModelConfig):
    """The cross-attention's K and V (B, F, KV, hd) from the encoder output."""
    cdt = enc_out.dtype
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(cdt))
    if cfg.qkv_bias:
        k = k + p["bk"].to(cdt)[None, None]
        v = v + p["bv"].to(cdt)[None, None]
    return k, v.contiguous()


def cross_attn_train(p: Params, x: torch.Tensor, enc_kv, cfg: ModelConfig,
                     impl: str = "auto") -> torch.Tensor:
    """Cross-attention against the encoder's K/V (no rope, no mask), through
    ``flash_attention_train``; its output (B, S, D) before the residual."""
    k, v = enc_kv
    spec = AttnSpec(causal=False, window=None, softcap=cfg.attn_softcap,
                    block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    return _attn_out(p, flash_attention_train(_cross_q(p, x, cfg), k, v, spec, impl))


def _attn_spec(cfg: ModelConfig, desc: LayerDesc, causal: bool = True) -> AttnSpec:
    return AttnSpec(
        causal=causal,
        window=cfg.sliding_window if desc.local else None,
        softcap=cfg.attn_softcap,
        block_q=cfg.attn_block_q,
        block_k=cfg.attn_block_k,
    )


def _attn_out(p: Params, out: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig, desc: LayerDesc,
         groups: Optional[int] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The FFN sub-layer on ``h`` (before the residual add) and, for a MoE
    layer, its aux losses. ``groups`` is the MoE's decode groups. A layer
    without a mixer has one norm, ``ln``."""
    hn = rmsnorm(h, p["ln2" if desc.mixer is not None else "ln"], cfg.norm_eps)
    if desc.ffn == "moe":
        return moe_lib.moe_apply(p["ffn"], hn, cfg, groups)
    return mlp_apply(p["ffn"], hn, cfg), None


def _serve_ffn(p: Params, h: torch.Tensor, cfg: ModelConfig, desc: LayerDesc,
               groups: Optional[int] = None) -> torch.Tensor:
    """:func:`_ffn`'s output in a prefill or decode call, a MoE layer inside
    a ``model.moe`` device span."""
    if desc.ffn != "moe":
        return _ffn(p, h, cfg, desc, groups)[0]
    with telemetry.get_recorder().span("model.moe", cat="model", device=h.device):
        return _ffn(p, h, cfg, desc, groups)[0]


# ---------------------------------------------------------------------------
# unit (scan body) param init
# ---------------------------------------------------------------------------

def init_unit(gen: torch.Generator, cfg: ModelConfig) -> Params:
    pdt = dtype_of(cfg.param_dtype)
    p = {}
    for j, d in enumerate(scan_unit(cfg)):
        lp: Params = {"ln": init_rmsnorm(cfg.d_model, pdt, gen.device)}
        if d.mixer == "attn":
            lp["attn"] = init_attention(gen, cfg)
        elif d.mixer == "mamba":
            lp["mamba"] = mamba_lib.init_mamba(gen, cfg)
        if d.cross:
            lp["cross_ln"] = init_rmsnorm(cfg.d_model, pdt, gen.device)
            lp["cross"] = init_attention(gen, cfg)
        if d.ffn is not None:
            if d.mixer is not None:
                lp["ln2"] = init_rmsnorm(cfg.d_model, pdt, gen.device)
            lp["ffn"] = (moe_lib.init_moe(gen, cfg) if d.ffn == "moe"
                         else init_mlp(gen, cfg, cfg.d_ff))
        p[f"L{j}"] = lp
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params on ``gen``'s device; units stacked on a layer axis.
    With one unit the drawn unit becomes the stack as views (nothing is
    copied, so the params are held once). With several, each unit is drawn
    and copied into its slot of the stacked tensors at once, so the peak is
    one copy of the params plus one unit. The draws are in unit order
    either way."""
    params: Params = {"embed": init_embedding(gen, cfg)}
    U = n_units(cfg)
    first = init_unit(gen, cfg)
    if U == 1:
        units = tree_map(lambda t: t.unsqueeze(0), first)
    else:
        units = tree_map(lambda t: t.new_empty((U,) + tuple(t.shape)), first)
        for u in range(U):
            one = first if u == 0 else init_unit(gen, cfg)
            tree_map(lambda dst, src: dst[u].copy_(src), units, one)
            del one
    del first
    params["units"] = units
    params["final_ln"] = init_rmsnorm(cfg.d_model, dtype_of(cfg.param_dtype), gen.device)
    if cfg.enc_dec:
        params["encoder"] = init_encoder(gen, cfg)
    return params


def init_encoder(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The whisper encoder: ``n_enc_layers`` blocks (norm, attention, norm,
    MLP) stacked on a layer axis, and its final norm."""
    pdt = dtype_of(cfg.param_dtype)

    def one():
        return {"ln": init_rmsnorm(cfg.d_model, pdt, gen.device),
                "attn": init_attention(gen, cfg),
                "ln2": init_rmsnorm(cfg.d_model, pdt, gen.device),
                "ffn": init_mlp(gen, cfg, cfg.d_ff)}

    blocks = [one() for _ in range(cfg.n_enc_layers)]
    return {"blocks": _stack_units(blocks),
            "final_ln": init_rmsnorm(cfg.d_model, pdt, gen.device)}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor   # (B, Sc, KV, hd)
    v: torch.Tensor


def layer_cache_len(cfg: ModelConfig, desc: LayerDesc, max_len: int) -> int:
    if desc.local and cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_unit_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Dict:
    """Zero cache for ONE unit (to be stacked over units). ``max_len`` sizes
    attention caches; the ssm family's state does not grow with it."""
    cdt = dtype_of(cfg.compute_dtype)
    cache: Dict[str, Any] = {}
    for j, d in enumerate(scan_unit(cfg)):
        if d.mixer == "attn":
            shape = (batch, layer_cache_len(cfg, d, max_len), cfg.n_kv_heads, cfg.head_dim)
            cache[f"kv{j}"] = KVCache(k=torch.zeros(shape, dtype=cdt, device=device),
                                      v=torch.zeros(shape, dtype=cdt, device=device))
            if d.cross:
                shape = (batch, cfg.enc_frames, cfg.n_kv_heads, cfg.head_dim)
                cache[f"cross{j}"] = KVCache(k=torch.zeros(shape, dtype=cdt, device=device),
                                             v=torch.zeros(shape, dtype=cdt, device=device))
            continue
        if d.mixer is None:
            continue
        mb = cfg.mamba
        Hm = mb.n_heads(cfg.d_model)
        conv_dim = mb.d_inner(cfg.d_model) + 2 * mb.n_groups * mb.d_state
        cache[f"mamba{j}"] = mamba_lib.MambaCache(
            ssm=torch.zeros((batch, Hm, mb.head_dim, mb.d_state), dtype=torch.float32,
                            device=device),
            conv=torch.zeros((batch, mb.d_conv - 1, conv_dim), dtype=cdt, device=device),
        )
    return cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Dict:
    """Zero decode cache, units stacked on the layer axis."""
    one = init_unit_cache(cfg, batch, max_len, device)
    U = n_units(cfg)
    units = tree_map(lambda x: x[None].expand((U,) + tuple(x.shape)).contiguous(), one)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device), "units": units}
    if cfg.enc_dec:
        cache["enc_len"] = _enc_len(batch, cfg.enc_frames, device)
    return cache


def _enc_len(B: int, F: int, device) -> torch.Tensor:
    """``kv_len`` of the cross decode, (B,) int32 of F (every frame valid):
    made once per cache, not once per tick, as a decode tick is host-bound."""
    return torch.full((B,), F, dtype=torch.int32, device=device)


def _stack_units(caches: List[Dict]) -> Dict:
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *caches)


def _prefill_kv_cache(k, v, cfg: ModelConfig, desc: LayerDesc, max_len: int) -> KVCache:
    """Arrange prefill K/V into the decode cache layout (ring for local)."""
    B, S = k.shape[:2]
    L = layer_cache_len(cfg, desc, max_len)
    if (L >= max_len and S <= L) or S < L:
        pad = (0, 0, 0, 0, 0, L - S)
        return KVCache(k=F.pad(k, pad), v=F.pad(v, pad))
    # ring: slot t % L holds the last position congruent to t
    slots = (S - L + torch.arange(L, device=k.device)) % L
    kc, vc = torch.zeros_like(k[:, :L]), torch.zeros_like(v[:, :L])
    kc[:, slots] = k[:, S - L:]
    vc[:, slots] = v[:, S - L:]
    return KVCache(k=kc, v=vc)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def attn_prefill(p: Params, hn: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                 desc: LayerDesc, max_len: int, impl: str = "auto"
                 ) -> Tuple[torch.Tensor, KVCache]:
    """One attention sub-layer over the prompt: (its output (B, S, D) before
    the residual add, the layer's decode cache)."""
    q, k, v = _qkv(p, hn, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    spec = _attn_spec(cfg, desc)
    out = fa_ops.flash_attention(q, k, v, causal=spec.causal, window=spec.window,
                                 softcap=spec.softcap, impl=impl)
    return _attn_out(p, out), _prefill_kv_cache(k, v, cfg, desc, max_len)


def _need_enc(cfg: ModelConfig, enc_embeds, params: Params, impl: str):
    """The encoder's output for an encoder-decoder config (None otherwise)."""
    if not cfg.enc_dec:
        return None
    if enc_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder config: pass enc_embeds "
                         f"(B, {cfg.enc_frames}, {cfg.d_model})")
    return encoder_forward(params["encoder"], enc_embeds, cfg, impl)


def cross_prefill(p: Params, hc: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig,
                  impl: str = "auto") -> Tuple[torch.Tensor, KVCache]:
    """One cross-attention sub-layer over the prompt: (its output before the
    residual add, the frozen ``cross`` cache of the encoder's K/V)."""
    k, v = enc_kv_for_cross(p, enc_out, cfg)
    out = fa_ops.flash_attention(_cross_q(p, hc, cfg), k, v, causal=False,
                                 softcap=cfg.attn_softcap, impl=impl)
    return _attn_out(p, out), KVCache(k=k, v=v)


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int,
            impl: str = "auto", positions: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt, build the decode cache. Returns (last-token logits
    (B, 1, V) f32, cache). ``max_len`` sizes the attention caches;
    ``positions`` (B, S) or, under M-RoPE, (B, S, 3) default to the text
    positions; ``enc_embeds`` (B, F, D) is the encoder's input, required by
    an encoder-decoder config."""
    B, S = tokens.shape
    descs = scan_unit(cfg)
    h = embed_tokens(params["embed"], tokens, cfg)
    if positions is None:
        positions = _text_positions(B, S, cfg, tokens.device)
    enc_out = _need_enc(cfg, enc_embeds, params, impl)
    caches = []
    for u in range(n_units(cfg)):
        unit_p = tree_map(lambda t: t[u], params["units"])
        entries = {}
        for j, d in enumerate(descs):
            p = unit_p[f"L{j}"]
            if d.mixer is not None:
                hn = rmsnorm(h, p["ln"], cfg.norm_eps)
                if d.mixer == "attn":
                    out, entries[f"kv{j}"] = attn_prefill(p["attn"], hn, positions, cfg, d,
                                                          max_len, impl)
                else:
                    out, entries[f"mamba{j}"] = mamba_lib.mamba_prefill(p["mamba"], hn, cfg,
                                                                        impl)
                h = h + out
            if d.cross:
                hc = rmsnorm(h, p["cross_ln"], cfg.norm_eps)
                out, entries[f"cross{j}"] = cross_prefill(p["cross"], hc, enc_out, cfg, impl)
                h = h + out
            if d.ffn is not None:
                h = h + _serve_ffn(p, h, cfg, d)
        caches.append(entries)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    logits = lm_logits(params["embed"], h[:, -1:], cfg)
    cache = {"pos": torch.full((), S, dtype=torch.int32, device=tokens.device),
             "units": _stack_units(caches)}
    if enc_out is not None:
        cache["enc_len"] = _enc_len(B, enc_out.shape[1], tokens.device)
    return logits, cache


def lane_positions(pos: torch.Tensor, lanes: int) -> torch.Tensor:
    """The cache's ``pos`` (a scalar, or one value per replica of a folded
    batch whose replicas own equal runs of lanes) as one value per lane."""
    if pos.dim() == 0:
        return pos.expand(lanes)
    return pos.repeat_interleave(lanes // pos.shape[0])


def attn_decode(p: Params, hn: torch.Tensor, kv: KVCache, pos: torch.Tensor,
                cfg: ModelConfig, positions: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """One attention sub-layer for one new token per lane at cache positions
    ``pos`` (B,): rope at ``positions`` ((B, 1), or (B, 1, 3) under M-RoPE),
    the new K/V written in place at slot ``pos % L`` of each lane's cache,
    and attention over its first ``min(pos + 1, L)`` slots (no causal or
    window mask: a local layer's window is its ring). Returns the output
    (B, 1, D) before the residual add."""
    B = hn.shape[0]
    q, k, v = _qkv(p, hn, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    L = kv.k.shape[1]
    lanes = torch.arange(B, device=hn.device)
    slot = (pos % L).to(torch.long)
    kv.k[lanes, slot] = k[:, 0]
    kv.v[lanes, slot] = v[:, 0]
    kv_len = torch.clamp(pos + 1, max=L).to(torch.int32)
    out = fa_ops.flash_attention_decode(q, kv.k, kv.v, kv_len, softcap=cfg.attn_softcap,
                                        impl=impl)
    return _attn_out(p, out)


def cross_decode(p: Params, hc: torch.Tensor, ckv: KVCache, enc_len: torch.Tensor,
                 cfg: ModelConfig, impl: str = "auto") -> torch.Tensor:
    """One cross-attention sub-layer for one new token per lane against the
    frozen encoder cache, every one of its ``enc_len`` (B,) frames valid;
    its output (B, 1, D) before the residual add."""
    out = fa_ops.flash_attention_decode(_cross_q(p, hc, cfg), ckv.k, ckv.v, enc_len,
                                        softcap=cfg.attn_softcap, impl=impl)
    return _attn_out(p, out)


def decode_step(params: Params, cache: Dict, token: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor] = None, impl: str = "auto"
                ) -> Tuple[torch.Tensor, Dict]:
    """One serving step: next-token logits (B, 1, V) f32 and the cache.
    ``token`` is (B, 1); ``positions``, the rope positions (B, 1) or (B, 1,
    3) under M-RoPE, default to the cache's; ``impl`` as for
    :func:`prefill`. The cache's tensors are updated in place (one K/V
    slot per lane of each attention layer, the whole state of each mamba
    layer) and returned; ``pos``, a scalar or one value per replica of a
    folded batch, comes back advanced by one. Each replica's lanes are one
    MoE decode group, as each replica decodes alone in the reference."""
    descs = scan_unit(cfg)
    B = token.shape[0]
    pos = lane_positions(cache["pos"], B)
    groups = cache["pos"].numel()
    h = embed_tokens(params["embed"], token, cfg)
    if positions is None:
        positions = _text_positions(B, 1, cfg, token.device, pos)
    for u in range(n_units(cfg)):
        unit_p = tree_map(lambda t: t[u], params["units"])
        unit_c = tree_map(lambda t: t[u], cache["units"])
        for j, d in enumerate(descs):
            p = unit_p[f"L{j}"]
            if d.mixer is not None:
                hn = rmsnorm(h, p["ln"], cfg.norm_eps)
                if d.mixer == "attn":
                    out = attn_decode(p["attn"], hn, unit_c[f"kv{j}"], pos, cfg, positions,
                                      impl)
                else:
                    out, new = mamba_lib.mamba_decode_step(p["mamba"], hn,
                                                           unit_c[f"mamba{j}"], cfg)
                    tree_map(lambda dst, src: dst.copy_(src), unit_c[f"mamba{j}"], new)
                h = h + out
            if d.cross:
                hc = rmsnorm(h, p["cross_ln"], cfg.norm_eps)
                h = h + cross_decode(p["cross"], hc, unit_c[f"cross{j}"], cache["enc_len"],
                                     cfg, impl)
            if d.ffn is not None:
                h = h + _serve_ffn(p, h, cfg, d, groups)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    logits = lm_logits(params["embed"], h, cfg)
    return logits, {**cache, "pos": cache["pos"] + 1}


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("moe_aux", "moe_zloss")}


def encoder_forward(params: Params, enc_embeds: torch.Tensor, cfg: ModelConfig,
                    impl: str = "auto") -> torch.Tensor:
    """The bidirectional encoder over stub frame embeddings (B, F, D): each
    block's self-attention (rope at ``arange(F)``, non-causal) through
    ``flash_attention_train`` and its MLP, each block recomputed in the
    backward under ``remat == "full"``, then the final norm."""
    h = enc_embeds.to(dtype_of(cfg.compute_dtype))
    B, F, _ = h.shape
    positions = torch.arange(F, device=h.device)[None].expand(B, F)
    spec = AttnSpec(causal=False, softcap=cfg.attn_softcap, block_q=cfg.attn_block_q,
                    block_k=cfg.attn_block_k)

    def block(h, p):
        hn = rmsnorm(h, p["ln"], cfg.norm_eps)
        q, k, v = _qkv(p["attn"], hn, cfg)
        q, k = apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)
        h = h + _attn_out(p["attn"], flash_attention_train(q, k, v, spec, impl))
        return h + mlp_apply(p["ffn"], rmsnorm(h, p["ln2"], cfg.norm_eps), cfg)

    for i in range(cfg.n_enc_layers):
        p = tree_map(lambda t: t[i], params["blocks"])
        h = (checkpoint(block, h, p, use_reentrant=False) if cfg.remat == "full"
             else block(h, p))
    return rmsnorm(h, params["final_ln"], cfg.norm_eps)


def _unit_forward(h: torch.Tensor, unit_p: Params, positions: torch.Tensor,
                  cfg: ModelConfig, impl: str = "auto",
                  enc_out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Apply one unit: each layer's mixer (attention through
    ``flash_attention_train``, or mamba), its cross-attention against
    ``enc_out`` (encoder-decoder configs) and its FFN, with their residuals.
    Returns (h, the unit's summed MoE aux losses)."""
    aux = _zero_aux(h.device)
    for j, d in enumerate(scan_unit(cfg)):
        p = unit_p[f"L{j}"]
        if d.mixer == "attn":
            hn = rmsnorm(h, p["ln"], cfg.norm_eps)
            q, k, v = _qkv(p["attn"], hn, cfg)
            q, k = _rope_qk(q, k, positions, cfg)
            out = flash_attention_train(q, k, v, _attn_spec(cfg, d), impl)
            h = h + _attn_out(p["attn"], out)
        elif d.mixer == "mamba":
            h = h + mamba_lib.mamba_forward(p["mamba"], rmsnorm(h, p["ln"], cfg.norm_eps), cfg)
        if d.cross:
            hc = rmsnorm(h, p["cross_ln"], cfg.norm_eps)
            h = h + cross_attn_train(p["cross"], hc, enc_kv_for_cross(p["cross"], enc_out, cfg),
                                     cfg, impl)
        if d.ffn is not None:
            out, a = _ffn(p, h, cfg, d)
            h = h + out
            if a is not None:
                aux = {k: aux[k] + a[k] for k in aux}
    return h, aux


def forward_train(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                  impl: str = "auto", positions: Optional[torch.Tensor] = None,
                  enc_embeds: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decoder forward: (hidden states (B, S, D), the MoE aux losses summed
    over layers). ``impl`` picks attention's path ("auto": the kernels on
    the card; "ref": their plain versions); ``positions`` and
    ``enc_embeds`` as for :func:`prefill`. The encoder's output enters each
    checkpointed unit as an input, so its gradient flows back through every
    unit's cross-attention."""
    B, S = tokens.shape
    h = embed_tokens(params["embed"], tokens, cfg)
    if positions is None:
        positions = _text_positions(B, S, cfg, tokens.device)
    enc_out = _need_enc(cfg, enc_embeds, params, impl)
    aux = _zero_aux(h.device)
    for u in range(n_units(cfg)):
        unit_p = tree_map(lambda t: t[u], params["units"])
        if cfg.remat == "full":
            h, a = checkpoint(_unit_forward, h, unit_p, positions, cfg, impl, enc_out,
                              use_reentrant=False)
        else:
            h, a = _unit_forward(h, unit_p, positions, cfg, impl, enc_out)
        aux = {k: aux[k] + a[k] for k in aux}
    return rmsnorm(h, params["final_ln"], cfg.norm_eps), aux


def _chunk_loss(embed: Params, h: torch.Tensor, labels: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Summed cross-entropy of one chunk: (B, chunk, V) float32 logits."""
    logits = lm_logits(embed, h, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    return torch.sum(lse - gold)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            impl: str = "auto") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-mean cross-entropy, the vocab projection taken ``loss_chunk``
    positions at a time, each chunk checkpointed (its logits recomputed in
    the backward), as the reference's chunk scan, plus the MoE aux losses.
    Returns (the total, {"ce_loss", "moe_aux", "moe_zloss"})."""
    tokens, labels = batch["tokens"], batch["labels"]
    h, aux = forward_train(params, tokens, cfg, impl, positions=batch.get("positions"),
                           enc_embeds=batch.get("enc_embeds"))
    B, S, _ = h.shape
    chunk = min(cfg.loss_chunk, S)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_loss, params["embed"], h[:, sl], labels[:, sl],
                                   cfg, use_reentrant=False)
    loss = total / (B * S)
    return loss + aux["moe_aux"] + aux["moe_zloss"], {"ce_loss": loss, **aux}
