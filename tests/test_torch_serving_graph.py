"""The decode tick replayed from a graph (``ModelDecoder``'s static-buffer
path), on the CPU.

On the card a decoder captures each set of active replicas' model call as a
CUDA graph on its first tick and replays it on later ticks. Here the capture
seam (``dec._graphs``) is a stand-in whose replay calls the captured
function again on the static buffers it closed over, with the params it was
captured with; so the decoder's part -- the static token, ``pos`` and fold
buffers, the addresses a replay checks, the graphs dropped when ``params``
is rebound, the counters -- runs here against an eager decoder, bit for
bit. A missed copy into a static buffer, or a replay after a rebind, gives
other tokens. For a MoE stack the stand-in's replay runs the function with
the tallies diverted (``moe.tallied``), as a graph's replay runs no Python,
and then appends the recorded entries as the card's replay does: the route
and drop tallies must come out entry for entry as the eager decoder's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import archs
from repro_torch.models import moe, transformer
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.serving import ModelDecoder, replica

COUNTERS = ("serve.decode.graph.captures", "serve.decode.graph.replays", "serve.decode.eager")


class CallReplay:
    """The capture seam on the CPU: the first run is the capture and counts
    in the open MoE tallies; a replay calls the captured function again with
    the tallies diverted, as a graph's replay runs no Python, then appends
    the recorded entries (``CudaGraphs``' replay)."""

    def capture(self, fn):
        def replay():
            static, retally = moe.tallied(fn)
            retally()
            return static

        return fn(), replay


def _decoder(arch: str, replay: bool, params=None) -> ModelDecoder:
    cfg = archs.smoke_cfg(archs.get(arch))
    dec = ModelDecoder(cfg, 2, 2, 40, seed=0, device="cpu", params=params)
    if replay:
        dec._graphs = CallReplay()
    return dec


def _waves(seed: int, *lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, n).astype(np.int32) for n in lengths]


def _script(dec: ModelDecoder, new_params):
    """Both replicas admitted and decoded; replica 1 done, so {0} alone;
    replica 1 re-admitted (a prefill writes its cache in place) and both
    decoded; the params rebound; both decoded, then replica 1 drained alone.
    Returns every call's tokens, the cache and pos after each call, and the
    decode counters."""
    out = []
    with telemetry.record_scope() as rec:
        def after(toks):
            out.append((np.asarray(toks).tolist(),
                        [t.clone() for t in tree_leaves(dec._cache["units"])],
                        dec._cache["pos"].clone()))

        after(list(dec.prefill_waves({0: _waves(1, 5, 7), 1: _waves(2, 6, 3)}).values()))
        for active in ([1, 1],) * 3 + ([1, 0],) * 3:
            after(dec.step(np.array(active, bool)))
        after(list(dec.prefill_waves({1: _waves(3, 9, 4)}).values()))
        for active in ([1, 1],) * 2:
            after(dec.step(np.array(active, bool)))
        dec.params = new_params
        for active in ([1, 1],) * 2 + ([0, 1],) * 3:
            after(dec.step(np.array(active, bool)))
        counts = {k: rec.get_counter(k) for k in COUNTERS}
    return out, counts


def _tallies(got, want):
    """Two tallies equal list by list, entry by entry, in order."""
    assert sorted(got) == sorted(want)
    for kind in want:
        assert len(got[kind]) == len(want[kind]), kind
        assert all(torch.equal(a, b) for a, b in zip(got[kind], want[kind])), kind


@pytest.mark.parametrize("arch", [
    "mamba2-780m", "gemma2-9b", "nemotron-3-nano-30b-a3b", "qwen3-moe-30b-a3b",
])
def test_replayed_ticks_equal_eager_ticks(arch):
    """Tokens, caches, ``pos`` and counters of ``_script``, and the route
    and drop tallies: nemotron-h's smoke ``ME*`` x 2 tallies its dropless
    MoE calls, qwen3-moe its capacity MoE's, replayed ticks included."""
    eager = _decoder(arch, replay=False)
    graph = _decoder(arch, replay=True, params=eager.params)
    gen = torch.Generator().manual_seed(7)
    new_params = eager.bundle.init(gen)
    with moe.count_routes() as routes, moe.count_drops() as drops:
        want, eager_counts = _script(eager, new_params)
    want_tally = {"routes": routes, "drops": drops}
    with moe.count_routes() as routes, moe.count_drops() as drops:
        got, graph_counts = _script(graph, new_params)
    assert len(got) == len(want)
    for i, ((t_got, c_got, p_got), (t_want, c_want, p_want)) in enumerate(zip(got, want)):
        assert t_got == t_want, f"call {i}: tokens differ"
        assert torch.equal(p_got, p_want), f"call {i}: pos differs"
        assert all(torch.equal(a, b) for a, b in zip(c_got, c_want)), f"call {i}: cache differs"
    assert eager_counts == {COUNTERS[0]: 0, COUNTERS[1]: 0, COUNTERS[2]: 13}
    # captures: {0, 1}, {0}, {0, 1} again after the rebind, {1}
    assert graph_counts == {COUNTERS[0]: 4, COUNTERS[1]: 9, COUNTERS[2]: 0}
    cfg = eager.cfg
    n_moe = sum(d.ffn == "moe" for d in transformer.scan_unit(cfg)) * transformer.n_units(cfg)
    decode = sum(len(t.get("decode", [])) for t in want_tally.values())
    assert decode == 13 * n_moe
    _tallies(routes, want_tally["routes"])
    _tallies(drops, want_tally["drops"])


def test_static_inputs_are_kept_per_set():
    dec = _decoder("mamba2-780m", replay=True)
    dec.prefill_waves({0: _waves(1, 5, 7), 1: _waves(2, 6, 3)})
    for active in ([1, 1], [1, 0], [0, 1], [1, 1], [1, 0]):
        dec.step(np.array(active, bool))
    assert sorted(dec._static) == [(0,), (0, 1), (1,)]
    assert sorted(dec._replays) == [(0,), (0, 1), (1,)]
    assert dec._static[(0,)]["units"] is None
    fold = dec._static[(0, 1)]["units"]
    for buf, leaf in zip(tree_leaves(fold), tree_leaves(dec._cache["units"])):
        assert buf.shape == (leaf.shape[1], 2 * leaf.shape[2]) + tuple(leaf.shape[3:])
    # the two-replica fold fills that buffer; one replica's is a view of its cache
    lanes = dec._lanes((0, 1), dec._static[(0, 1)])
    assert [t.data_ptr() for t in tree_leaves(lanes["units"])] == \
        [t.data_ptr() for t in tree_leaves(fold)]
    one = dec._lanes((1,), dec._static[(1,)])
    assert [t.data_ptr() for t in tree_leaves(one["units"])] == \
        [t[1].data_ptr() for t in tree_leaves(dec._cache["units"])]


def test_replay_refuses_a_rebound_cache_leaf():
    dec = _decoder("mamba2-780m", replay=True)
    dec.prefill_waves({0: _waves(1, 5, 7)})
    dec.step(np.array([True, False]))
    dec.step(np.array([True, False]))
    dec._cache["units"] = tree_map(torch.clone, dec._cache["units"])
    with pytest.raises(RuntimeError, match="rebound"):
        dec.step(np.array([True, False]))


def test_rebinding_params_drops_the_graphs():
    dec = _decoder("mamba2-780m", replay=True)
    dec.prefill_waves({0: _waves(1, 5, 7), 1: _waves(2, 6, 3)})
    dec.step(np.array([True, True]))
    dec.step(np.array([True, False]))
    assert len(dec._replays) == 2
    dec.params = dec.params
    assert not dec._replays and len(dec._static) == 2


@pytest.mark.parametrize("arch", [
    "mamba2-780m", "gemma2-9b", "qwen2-72b", "nemotron-3-nano-30b-a3b", "qwen3-moe-30b-a3b",
    "jamba-1.5-large-398b",
])
def test_capture_rule_reads_the_device(arch):
    cfg = archs.smoke_cfg(archs.get(arch))
    assert replica.captures_decode(cfg, torch.device("cuda")) is True
    assert replica.captures_decode(cfg, torch.device("cpu")) is False


def _moe_call(dropless: bool):
    """One MoE layer of the nemotron-h (dropless) or qwen3-moe (capacity)
    smoke config at decode (S 1, 4 lanes in 2 groups): the call, and the
    tally it appends to."""
    cfg = archs.smoke_cfg(archs.get("nemotron-3-nano-30b-a3b" if dropless
                                    else "qwen3-moe-30b-a3b"))
    gen = torch.Generator().manual_seed(5)
    p = moe.init_moe(gen, cfg)
    x = torch.randn(4, 1, cfg.d_model, generator=gen).to(p["wi"].dtype)
    return (lambda: moe.moe_apply(p, x, cfg, groups=2)[0],
            moe.count_routes if dropless else moe.count_drops)


@pytest.mark.parametrize("dropless", [True, False])
def test_tallied_call_counts_only_where_retallied(dropless):
    """Inside ``moe.tallied`` a MoE call appends nothing to the open tally
    (a capture's entries count nowhere); its ``retally`` appends copies of
    the entries the eager call makes, to the tallies open when it runs, each
    time it runs, and nothing where none is open."""
    call, count = _moe_call(dropless)
    with count() as want:
        eager = call()
    with count() as got:
        out, retally = moe.tallied(call)
        assert not got
        retally()
        retally()
    assert torch.equal(out, eager)
    _tallies(got, {"decode": want["decode"] * 2})
    # each retally a copy of its own
    assert len({e.untyped_storage().data_ptr() for e in got["decode"]}) == 2
    retally()   # no tally open: nothing to append to, and nothing raises
    assert len(got["decode"]) == 2 * len(want["decode"])


def test_tallied_records_nothing_without_moe():
    """A call with no MoE layer records nothing: its retally appends no
    list to an open tally."""
    out, retally = moe.tallied(lambda: torch.ones(3))
    with moe.count_routes() as routes, moe.count_drops() as drops:
        retally()
    assert torch.equal(out, torch.ones(3)) and routes == {} and drops == {}
