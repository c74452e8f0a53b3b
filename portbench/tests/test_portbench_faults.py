"""Each fault a cell can have, planted under the timed path, turns
``correct`` false; and the control (the plain reference one precision step
below the configuration's, in the program's place) fails the cell's limits.

Runs on the CPU at the tests' size, past the harness's look for a card.
The serving cell has no exchange between cards, so it has no such fault.
"""

import pytest
import torch

from portbench import harness, readings, weights


def _correct(tiny_cell, name, seed=2**31 + 3, seconds=1.5):
    return harness.run_cell(tiny_cell(name), seed, seconds, False, "cpu",
                            log=lambda m: None)["correct"]


# -- training rounds ----------------------------------------------------------

def _discard_mix(mp):
    """The exchange issues its gathers (the driver's own count holds) and
    its result is dropped: each satellite keeps its own params."""
    from repro_torch.core import fused

    real = fused.int8_gossip_matchings

    def discard(x, *a, **k):
        real(x, *a, **k)
        return x

    mp.setattr(fused, "int8_gossip_matchings", discard)


def _fl_unchanged(mp):
    from repro_torch.optim import adamw

    mp.setattr(adamw, "apply_updates_", lambda params, grads, state, cfg: {})
    _discard_mix(mp)


def _fl_half_batch(mp):
    from repro_torch.models import registry

    real = registry.ModelBundle.loss_fn

    def half(self, params, batch, impl="auto"):
        return real(self, params, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, impl)

    mp.setattr(registry.ModelBundle, "loss_fn", half)


def _fl_no_exchange(mp):
    _discard_mix(mp)


def _fl_grad_altered(mp):
    from repro_torch.optim import adamw

    real = adamw.apply_updates_

    def altered(params, grads, state, cfg):
        k = [p for p, _ in weights.leaves(params)].index("units.L0.mamba.out")
        grads[k] = grads[k] * 2
        return real(params, grads, state, cfg)

    mp.setattr(adamw, "apply_updates_", altered)


# -- the exchange alone -------------------------------------------------------

def _slots_unchanged(mp):
    from repro_torch.core import fl

    mp.setattr(fl, "tdm_fla_round", lambda params, rel, n, cfg, *a, **k: (params, None))


def _slots_half_rows(mp):
    from repro_torch.core import fused

    real = fused.int8_gossip_matchings

    def half(x, diag, matchings, per_matching, **kw):
        out = real(x, diag, matchings, per_matching, **kw)
        h = x.shape[0] // 2
        return torch.cat([out[:h], x[h:]])

    mp.setattr(fused, "int8_gossip_matchings", half)


def _slots_no_exchange(mp):
    _discard_mix(mp)


def _slots_altered(mp):
    from repro_torch.kernels.tdm_compress import ops

    real = ops.dequant_accumulate

    def altered(q, scales, acc, w, **kw):
        out = real(q, scales, acc, w, **kw)
        out[0, 7] += 1.0
        return out

    mp.setattr(ops, "dequant_accumulate", altered)


# -- serving ------------------------------------------------------------------

def _serve_unchanged(mp):
    from repro_torch.models import mamba2

    real = mamba2.mamba_decode_step

    def stale(p, x_t, cache, cfg):
        out, _ = real(p, x_t, cache, cfg)
        return out, cache

    mp.setattr(mamba2, "mamba_decode_step", stale)


def _serve_half_batch(mp):
    from repro_torch.serving import replica

    real = replica.ModelDecoder._tokens

    def half(self, logits, k):
        toks = real(self, logits, k)
        h = self.batch // 2
        toks[:, h:] = toks[:, :h][:, : self.batch - h]
        return toks

    mp.setattr(replica.ModelDecoder, "_tokens", half)


def _serve_altered(mp):
    from repro_torch.serving import replica

    real = replica.ModelDecoder._tokens

    def altered(self, logits, k):
        toks = real(self, logits, k)
        toks[0, 0] = (toks[0, 0] + 1) % logits.shape[-1]
        return toks

    mp.setattr(replica.ModelDecoder, "_tokens", altered)


FAULTS = [
    ("fl_tdm_int8", _fl_unchanged), ("fl_tdm_int8", _fl_half_batch),
    ("fl_tdm_int8", _fl_no_exchange), ("fl_tdm_int8", _fl_grad_altered),
    ("tdm_slots_int8", _slots_unchanged), ("tdm_slots_int8", _slots_half_rows),
    ("tdm_slots_int8", _slots_no_exchange), ("tdm_slots_int8", _slots_altered),
    ("serve_short_chat", _serve_unchanged), ("serve_short_chat", _serve_half_batch),
    ("serve_short_chat", _serve_altered),
]


@pytest.mark.parametrize("cell", ["fl_tdm_int8", "tdm_slots_int8", "serve_short_chat"])
def test_sound_run_is_correct(tiny_cell, cell):
    assert _correct(tiny_cell, cell)


@pytest.mark.parametrize("cell,plant", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_planted_fault_is_not_correct(tiny_cell, monkeypatch, cell, plant):
    plant(monkeypatch)
    assert not _correct(tiny_cell, cell)


@pytest.mark.parametrize("cell", ["fl_tdm_int8", "tdm_slots_int8"])
def test_control_fails_the_limits(tiny_cell, cell):
    c = tiny_cell(cell)
    line = readings.read_seed(c, 2**31 + 5, 2.0, "cpu", control=True)
    assert any(v > c.limits[k] for k, v in line["control"].items()), line
    assert all(v <= c.limits[k] for k, v in line["program"].items()), line


def test_serving_control_lies_far_from_the_program(tiny_cell):
    """At 2 layers the float8 control moves the logits less than at 48 (the
    limit is set there, and held on the card by test_portbench_card.py);
    here it still reads well apart from the program."""
    c = tiny_cell("serve_short_chat")
    line = readings.read_seed(c, 2**31 + 5, 2.0, "cpu", control=True)
    assert line["program"]["logit_gap"] <= c.limits["logit_gap"]
    assert line["control"]["logit_gap"] > max(3 * line["program"]["logit_gap"], 0.05), line
