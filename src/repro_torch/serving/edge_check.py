"""A card check of the dense serving paths that a full-size cell misses.

:func:`dense_edge_check` takes gemma2-9b's smoke config (4 layers, window
16, 4 / 2 heads x 16) through :class:`ModelDecoder` on a CUDA device: one
``prefill_waves`` call that admits both replicas with prompts of 129-256
tokens (a bucket-256 wave), then ``ticks`` ticks of both replicas, each
local layer's ring of 16 slots engaged.

- float32 compute: the first tokens and every tick equal those of a CPU
  decoder with the same params;
- bf16 compute: the prefill launches the tensor-core attention kernel once
  per layer and every tick the decode kernel once per layer; the first
  local and global layers' attention, on the wave's prompts and on the
  caches the ticks left, lies within ``fa_tolerance`` of the plain version.

The launch counters are zeroed before each run. It raises
``AssertionError`` on the first check that fails. ``chip_smoke.py`` and the
card tests (``tests/test_torch_cuda.py``) both run it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

EDGE_TICKS = 24


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dense_edge_check(device, arch: str = "gemma2-9b", ticks: int = EDGE_TICKS) -> Dict:
    """Run the check on ``device`` (CUDA); returns what it saw: the prompt
    lengths, the bf16 run's launches, each checked layer's cache and
    kv_len, and the largest |kernel - plain| of the attention checks."""
    from repro_torch.configs import archs
    from repro_torch.kernels.flash_attention import flash_attention as fa_kern
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models import transformer
    from repro_torch.models.layers import embed_tokens, rmsnorm
    from repro_torch.pytree import tree_map
    from repro_torch.serving.replica import ModelDecoder

    base = archs.smoke_cfg(archs.get(arch))
    rng = np.random.default_rng(5)
    waves = {r: [rng.integers(0, base.vocab_size, n).astype(np.int32) for n in lens]
             for r, lens in ((0, (129, 200)), (1, (256, 160)))}
    lens = [len(p) for ps in waves.values() for p in ps]
    max_len = max(lens) + 1 + ticks + 8
    both = np.array([True, True])
    _require(ModelDecoder._bucket(min(lens)) == ModelDecoder._bucket(max(lens)) == 256,
             f"prompts {lens} are not one bucket-256 wave")

    cfg = base.replace(compute_dtype="float32")
    gpu = ModelDecoder(cfg, 2, 2, max_len, seed=3, device=device)
    cpu = ModelDecoder(cfg, 2, 2, max_len, seed=3, device="cpu")
    cpu.params = tree_map(lambda t: t.cpu(), gpu.params)
    fa_kern.reset_launch_counts()
    _require(gpu.prefill_waves(waves) == cpu.prefill_waves(waves),
             "f32: first tokens differ from a CPU decoder's")
    for t in range(ticks):
        _require(bool((gpu.step(both) == cpu.step(both)).all()),
                 f"f32: tick {t} differs from a CPU decoder's")
    want = {"flash_attention_fwd": cfg.n_layers, "flash_attention_fwd_wgmma": 0,
            "flash_attention_decode": cfg.n_layers * ticks, "flash_attention_bwd": 0}
    _require(fa_kern.launch_counts() == want,
             f"f32: launches {fa_kern.launch_counts()} != {want}")
    del gpu, cpu

    cfg = base
    dec = ModelDecoder(cfg, 2, 2, max_len, seed=3, device=device)
    fa_kern.reset_launch_counts()
    dec.prefill_waves(waves)
    for _ in range(ticks):
        dec.step(both)
    want = {"flash_attention_fwd": cfg.n_layers, "flash_attention_fwd_wgmma": cfg.n_layers,
            "flash_attention_decode": cfg.n_layers * ticks, "flash_attention_bwd": 0}
    _require(fa_kern.launch_counts() == want,
             f"bf16: launches {fa_kern.launch_counts()} != {want}")
    _require(int(dec._cache["pos"].min()) > cfg.sliding_window,
             "the ticks did not pass the window")

    width = ModelDecoder._bucket(max(lens))
    toks = np.zeros((len(lens), width), np.int64)
    for i, p in enumerate(waves[0] + waves[1]):
        toks[i, width - len(p):] = p
    tokens = torch.from_numpy(toks).to(device)
    positions = torch.arange(width, device=device)[None].expand(len(lens), width)
    gen = torch.Generator(device=device).manual_seed(31)
    worst, rings = 0.0, []
    with torch.no_grad():
        h = embed_tokens(dec.params["embed"], tokens, cfg)
        unit_p = tree_map(lambda t: t[0], dec.params["units"])
        for j, d in enumerate(transformer.scan_unit(cfg)):
            lp = unit_p[f"L{j}"]
            q, k, v = transformer._qkv(lp["attn"], rmsnorm(h, lp["ln"], cfg.norm_eps), cfg)
            q, k = transformer._rope_qk(q, k, positions, cfg)
            spec = transformer._attn_spec(cfg, d)
            kw = dict(causal=spec.causal, window=spec.window, softcap=spec.softcap)
            ok, err = ref.fa_close(ops.flash_attention(q, k, v, impl="cuda", **kw),
                                   ops.flash_attention(q, k, v, impl="ref", **kw))
            _require(ok, f"bf16: layer {j} prefill attention {err:.3g} outside fa_tolerance")
            worst = max(worst, err)
            kv = dec._cache["units"][f"kv{j}"]
            kc = torch.cat([kv.k[r, 0] for r in range(2)])
            vc = torch.cat([kv.v[r, 0] for r in range(2)])
            L = kc.shape[1]
            kv_len = torch.clamp(dec._cache["pos"].repeat_interleave(2), max=L).to(torch.int32)
            qd = torch.randn(len(lens), 1, cfg.n_heads, cfg.head_dim, generator=gen,
                             device=device).to(kc.dtype)
            ok, err = ref.fa_close(
                ops.flash_attention_decode(qd, kc, vc, kv_len, softcap=spec.softcap,
                                           impl="cuda"),
                ops.flash_attention_decode(qd, kc, vc, kv_len, softcap=spec.softcap,
                                           impl="ref"))
            _require(ok, f"bf16: layer {j} decode attention {err:.3g} outside fa_tolerance")
            worst = max(worst, err)
            rings.append(f"layer {j} ({'local' if spec.window else 'global'}): cache "
                         f"{L} slots, kv_len {kv_len.tolist()}")
    return {"config": cfg, "prompts": lens, "ticks": ticks, "launches": want,
            "rings": rings, "worst": worst}
