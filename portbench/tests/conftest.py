"""Shared helpers of the benchmark's CPU tests: the repository's ``src`` and
root on the path, and each cell shrunk to a size the CPU runs in seconds:
the training and exchange cells at the port's smoke widths, the serving cell
at the published widths with 2 layers (its logits then have the published
model's scale, which its limit is set at)."""

import copy
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import pytest  # noqa: E402

SMOKE = {
    "arch_variant": "smoke", "d_model": 64, "n_layer": 2, "vocab_size": 128,
    "ssm_cfg": {"layer": "Mamba2", "d_state": 16, "d_conv": 4, "expand": 2, "headdim": 8,
                "ngroups": 1, "chunk_size": 8},
}
TINY_MODEL = {"fl_rounds": SMOKE, "tdm_slots": SMOKE, "serve": {"n_layer": 2}}
TINY_TRAFFIC = {
    "fl_rounds": {"seq": 16, "rows": 2},
    "tdm_slots": {"sample_slot": [2, 3]},
    "serve": {"lanes": 2, "prompt_len": [8, 40], "max_new": [2, 6], "requests": 300,
              "checked_requests": 3, "profile": {"first": 1, "units": 2}},
}


def tiny(name: str):
    """The cell ``name`` at the port's smoke widths (CPU-sized)."""
    from portbench import harness

    c = harness.cell(name)
    c = copy.deepcopy(c)
    c.config.update(copy.deepcopy(TINY_MODEL[c.kind]))
    c.traffic.update(copy.deepcopy(TINY_TRAFFIC[c.kind]))
    return c


@pytest.fixture
def tiny_cell():
    return tiny
