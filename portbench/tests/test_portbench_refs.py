"""The plain references against the port, on the CPU at small sizes, with
the port computing in float32 so that the two are the same function."""

import numpy as np
import pytest
import torch

from portbench import counts, weights
from portbench.refs import adamw as ref_adamw
from portbench.refs import gossip, mamba2

SMOKE = counts.Mamba2(d_model=64, n_layer=2, vocab_size=128, d_state=16, d_conv=4,
                      expand=2, headdim=8, ngroups=1, chunk_size=8)
EPS = 1e-6


def _port_cfg():
    from repro_torch.configs import archs

    return archs.smoke_cfg(archs.get("mamba2-780m")).replace(compute_dtype="float32")


def _batch(seed, B=2, S=16):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, SMOKE.vocab_size, (B, S + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_weights_tree_is_the_ports():
    from repro_torch.models import registry
    from repro_torch.pytree import tree_flatten

    cfg = _port_cfg()
    ours = weights.make(SMOKE, 3, "cpu")
    theirs = registry.bundle(cfg).init(torch.Generator().manual_seed(0))
    (a, ta), (b, tb) = tree_flatten(ours), tree_flatten(theirs)
    assert ta == tb
    assert [x.shape for x in a] == [y.shape for y in b]
    assert sum(x.numel() for x in a) == SMOKE.params()


@pytest.mark.parametrize("seed", [1, 2])
def test_loss_and_gradients_match_the_port_in_f32(seed):
    from repro_torch.models import registry
    from repro_torch.pytree import tree_flatten, tree_unflatten

    cfg = _port_cfg()
    params = weights.make(SMOKE, seed, "cpu")
    batch = _batch(seed)
    leaves, td = tree_flatten(params)
    p1 = [x.clone().requires_grad_(True) for x in leaves]
    port, _ = registry.bundle(cfg).loss_fn(tree_unflatten(td, p1), batch)
    g1 = torch.autograd.grad(port, p1)
    p2 = [x.clone().requires_grad_(True) for x in leaves]
    ref = mamba2.loss(tree_unflatten(td, p2), batch["tokens"], batch["labels"], SMOKE, EPS)
    g2 = torch.autograd.grad(ref, p2)
    assert float(port.detach()) == pytest.approx(float(ref.detach()), rel=1e-5)
    for a, b in zip(g1, g2):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-7


def test_adamw_matches_the_ports():
    from repro_torch.optim import adamw

    opt = dict(peak_lr=5e-3, end_lr_frac=0.1, warmup_steps=2, decay_steps=100, b1=0.9,
               b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)
    g = torch.Generator().manual_seed(0)
    p = {"a": torch.randn(3, 5, generator=g), "b": torch.randn(7, generator=g)}
    cfg = adamw.OptConfig(**opt)
    state = adamw.init_opt_state(p, cfg)
    mine = [x.clone() for x in (p["a"], p["b"])]
    mu = [torch.zeros_like(x) for x in mine]
    nu = [torch.zeros_like(x) for x in mine]
    for step in range(4):
        grads = [torch.randn(3, 5, generator=g) * 3, torch.randn(7, generator=g) * 3]
        adamw.apply_updates_(p, list(grads), state, cfg)
        ref_adamw.step(mine, grads, mu, nu, step, opt)
        for a, b in zip((p["a"], p["b"]), mine):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_one_int8_mix_matches_the_ports_fused_exchange():
    from repro_torch.core import fl
    from repro_torch.core.relation import Relation

    n, block = 8, 1024
    x = weights.make(SMOKE, 5, "cpu", nodes=n)
    edges = [(0, 5), (0, 6), (2, 4), (2, 7), (1, 3)]
    rel = Relation.from_edges(edges, nodes=range(n))
    out, _ = fl.tdm_fla_round(x, rel, n, fl.TDMFLAConfig(compression="int8"))
    gap = gossip.mix_gap(gossip.flatten(out, block), gossip.flatten(x, block), edges, block)
    assert gap < 1e-5
    # int4 payloads lie far off the int8 mix
    low = gossip.mix_rows(gossip.flatten(x, block), edges, block, levels=7)
    assert gossip.mix_gap(low, gossip.flatten(x, block), edges, block) > 1e-2


def test_serving_logits_match_prefill_and_decode_in_f32():
    from repro_torch.models import transformer

    cfg = _port_cfg()
    params = weights.make(SMOKE, 9, "cpu")
    prompt = torch.randint(1, SMOKE.vocab_size, (1, 11), generator=torch.Generator().manual_seed(1))
    pad = 16 - prompt.shape[1]
    tokens = torch.cat([torch.zeros((1, pad), dtype=torch.long), prompt], dim=1)
    logits, cache = transformer.prefill(params, tokens, cfg, max_len=24)
    seq, got = tokens, [logits[0, -1]]
    for _ in range(4):
        nxt = got[-1].argmax().reshape(1, 1)
        seq = torch.cat([seq, nxt], dim=1)
        logits, cache = transformer.decode_step(params, cache, nxt, cfg)
        got.append(logits[0, -1])
    want = mamba2.logits(params, mamba2.hidden(params, seq, SMOKE, EPS))[0, 15:]
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-4)


def test_fp8_control_rounds_every_bf16_product():
    x = torch.linspace(-3, 3, 101)
    y = mamba2.fp8(x)
    assert not torch.equal(x, y)
    assert float((x - y).abs().max()) <= 3 * 2 ** -3
    assert np.isclose(float(mamba2.fp8(torch.tensor([448.0, 1.0]))[0]), 448.0)
