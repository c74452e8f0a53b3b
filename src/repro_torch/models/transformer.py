"""The LM decoder stack, ssm (mamba2) and dense (gemma2, granite, qwen2)
families: init, prefill and decode; training forward and loss for the ssm
family.

Counterpart of the JAX package's ``models/transformer.py``. A config is
compiled to a list of :class:`LayerDesc` per *scan unit*:

- ssm (mamba2):                    unit = [mamba],               L units
- dense (granite/qwen2):           unit = [attn+mlp],            L units
- gemma2:                          unit = [attn(local)+mlp,
                                           attn(global)+mlp],    L/2 units

MoE, hybrid and encoder-decoder configs, and M-RoPE (qwen2-vl), raise
``NotImplementedError``; so do the dense family's training forward and loss
(attention's backward comes with the dense training slice). Units are
stacked on a leading layer axis as in the reference (its ``lax.scan``
layout), and the forward loops over them. ``cfg.remat`` is a memory setting
with no numeric effect and is ignored.

Caches (``{"pos", "units"}`` as in the reference): per attention layer a
:class:`KVCache` (length ``max_len``, or the window for local layers: a
ring, slot ``t % L`` holding position t), per mamba layer a
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

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models.attention import AttnSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
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
    mixer: str                  # "attn" | "mamba"
    local: bool = False         # sliding-window attention
    ffn: Optional[str] = None   # "dense" | None


def _unported(cfg: ModelConfig, what: str = ""):
    return NotImplementedError(
        f"model family {cfg.family!r} ({cfg.name}){what} is not ported yet; the "
        "port covers the ssm and dense families (ROADMAP queue 1, model zoo)"
    )


def scan_unit(cfg: ModelConfig) -> List[LayerDesc]:
    """The per-unit layer pattern for this config (see module docstring)."""
    if cfg.family == "ssm":
        return [LayerDesc("mamba", ffn=None if cfg.no_ffn else "dense")]
    if cfg.family == "hybrid" or cfg.enc_dec or cfg.moe is not None:
        raise _unported(cfg)
    if cfg.local_global_alternate:
        return [LayerDesc("attn", local=True, ffn="dense"),
                LayerDesc("attn", local=False, ffn="dense")]
    return [LayerDesc("attn", local=cfg.force_local, ffn="dense")]


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
    if cfg.mrope_sections is not None:
        raise _unported(cfg, " with M-RoPE")
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)


def _attn_spec(cfg: ModelConfig, desc: LayerDesc, causal: bool = True) -> AttnSpec:
    return AttnSpec(
        causal=causal,
        window=cfg.sliding_window if desc.local else None,
        softcap=cfg.attn_softcap,
    )


def _attn_out(p: Params, out: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))


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
        else:
            lp["mamba"] = mamba_lib.init_mamba(gen, cfg)
        if d.ffn is not None:
            lp["ln2"] = init_rmsnorm(cfg.d_model, pdt, gen.device)
            lp["ffn"] = init_mlp(gen, cfg, cfg.d_ff)
        p[f"L{j}"] = lp
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params on ``gen``'s device; units stacked on a layer axis.
    Each unit is drawn and copied into the stacked tensors at once, so the
    peak is one copy of the params plus one unit."""
    params: Params = {"embed": init_embedding(gen, cfg)}
    U = n_units(cfg)
    first = init_unit(gen, cfg)
    units = tree_map(lambda t: t.new_empty((U,) + tuple(t.shape)), first)
    for u in range(U):
        one = first if u == 0 else init_unit(gen, cfg)
        tree_map(lambda dst, src: dst[u].copy_(src), units, one)
        del one
    del first
    params["units"] = units
    params["final_ln"] = init_rmsnorm(cfg.d_model, dtype_of(cfg.param_dtype), gen.device)
    return params


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
    return {"pos": torch.zeros((), dtype=torch.int32, device=device), "units": units}


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


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int,
            impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """Run the prompt, build the decode cache. Returns (last-token logits
    (B, 1, V) f32, cache). ``max_len`` sizes the attention caches."""
    B, S = tokens.shape
    descs = scan_unit(cfg)
    h = embed_tokens(params["embed"], tokens, cfg)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    caches = []
    for u in range(n_units(cfg)):
        unit_p = tree_map(lambda t: t[u], params["units"])
        entries = {}
        for j, d in enumerate(descs):
            p = unit_p[f"L{j}"]
            hn = rmsnorm(h, p["ln"], cfg.norm_eps)
            if d.mixer == "attn":
                out, entries[f"kv{j}"] = attn_prefill(p["attn"], hn, positions, cfg, d,
                                                      max_len, impl)
            else:
                out, entries[f"mamba{j}"] = mamba_lib.mamba_prefill(p["mamba"], hn, cfg,
                                                                    impl)
            h = h + out
            if d.ffn is not None:
                h = h + mlp_apply(p["ffn"], rmsnorm(h, p["ln2"], cfg.norm_eps), cfg)
        caches.append(entries)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    logits = lm_logits(params["embed"], h[:, -1:], cfg)
    pos = torch.full((), S, dtype=torch.int32, device=tokens.device)
    return logits, {"pos": pos, "units": _stack_units(caches)}


def lane_positions(pos: torch.Tensor, lanes: int) -> torch.Tensor:
    """The cache's ``pos`` (a scalar, or one value per replica of a folded
    batch whose replicas own equal runs of lanes) as one value per lane."""
    if pos.dim() == 0:
        return pos.expand(lanes)
    return pos.repeat_interleave(lanes // pos.shape[0])


def attn_decode(p: Params, hn: torch.Tensor, kv: KVCache, pos: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """One attention sub-layer for one new token per lane at positions
    ``pos`` (B,): rope at ``pos``, the new K/V written in place at slot
    ``pos % L`` of each lane's cache, and attention over its first
    ``min(pos + 1, L)`` slots (no causal or window mask: a local layer's
    window is its ring). Returns the output (B, 1, D) before the residual
    add."""
    B = hn.shape[0]
    q, k, v = _qkv(p, hn, cfg)
    q, k = _rope_qk(q, k, pos[:, None], cfg)
    L = kv.k.shape[1]
    lanes = torch.arange(B, device=hn.device)
    slot = (pos % L).to(torch.long)
    kv.k[lanes, slot] = k[:, 0]
    kv.v[lanes, slot] = v[:, 0]
    kv_len = torch.clamp(pos + 1, max=L).to(torch.int32)
    out = fa_ops.flash_attention_decode(q, kv.k, kv.v, kv_len, softcap=cfg.attn_softcap)
    return _attn_out(p, out)


def decode_step(params: Params, cache: Dict, token: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict]:
    """One serving step: next-token logits (B, 1, V) f32 and the cache.
    ``token`` is (B, 1). The cache's tensors are updated in place (one K/V
    slot per lane of each attention layer, the whole state of each mamba
    layer) and returned; ``pos``, a scalar or one value per replica of a
    folded batch, comes back advanced by one."""
    descs = scan_unit(cfg)
    B = token.shape[0]
    pos = lane_positions(cache["pos"], B)
    h = embed_tokens(params["embed"], token, cfg)
    for u in range(n_units(cfg)):
        unit_p = tree_map(lambda t: t[u], params["units"])
        unit_c = tree_map(lambda t: t[u], cache["units"])
        for j, d in enumerate(descs):
            p = unit_p[f"L{j}"]
            hn = rmsnorm(h, p["ln"], cfg.norm_eps)
            if d.mixer == "attn":
                out = attn_decode(p["attn"], hn, unit_c[f"kv{j}"], pos, cfg)
            else:
                out, new = mamba_lib.mamba_decode_step(p["mamba"], hn, unit_c[f"mamba{j}"],
                                                       cfg)
                tree_map(lambda dst, src: dst.copy_(src), unit_c[f"mamba{j}"], new)
            h = h + out
            if d.ffn is not None:
                h = h + mlp_apply(p["ffn"], rmsnorm(h, p["ln2"], cfg.norm_eps), cfg)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    logits = lm_logits(params["embed"], h, cfg)
    return logits, {"pos": cache["pos"] + 1, "units": cache["units"]}


# ---------------------------------------------------------------------------
# training forward (ssm family)
# ---------------------------------------------------------------------------

def _unit_forward(h: torch.Tensor, unit_p: Params, cfg: ModelConfig) -> torch.Tensor:
    """Apply one unit (mamba layers; attention's backward is not ported)."""
    for j, d in enumerate(scan_unit(cfg)):
        if d.mixer != "mamba":
            raise _unported(cfg, "'s training forward (attention backward)")
        p = unit_p[f"L{j}"]
        hn = rmsnorm(h, p["ln"], cfg.norm_eps)
        h = h + mamba_lib.mamba_forward(p["mamba"], hn, cfg)
        if d.ffn is not None:
            h = h + mlp_apply(p["ffn"], rmsnorm(h, p["ln2"], cfg.norm_eps), cfg)
    return h


def forward_train(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Decoder forward: hidden states (B, S, D)."""
    h = embed_tokens(params["embed"], tokens, cfg)
    for u in range(n_units(cfg)):
        unit_p = tree_map(lambda t: t[u], params["units"])
        h = _unit_forward(h, unit_p, cfg)
    return rmsnorm(h, params["final_ln"], cfg.norm_eps)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-mean cross-entropy, the vocab projection taken ``loss_chunk``
    positions at a time (the logits of one chunk at once, as the reference's
    chunk scan)."""
    tokens, labels = batch["tokens"], batch["labels"]
    h = forward_train(params, tokens, cfg)
    B, S, _ = h.shape
    chunk = min(cfg.loss_chunk, S)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = lm_logits(params["embed"], h[:, sl], cfg)       # (B,chunk,V) f32
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[:, sl, None].long(), dim=-1)[..., 0]
        total = total + torch.sum(lse - gold)
    loss = total / (B * S)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    return loss, {"ce_loss": loss, "moe_aux": zero, "moe_zloss": zero}
