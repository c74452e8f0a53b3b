"""The port's ground-segment FL runs against the JAX reference's
``run_groundseg_fl``.

A child process (this file run as a script, with 8 forced XLA host devices)
runs the reference for 2 rounds of each config (one local step each) on
the mamba2-780m smoke model (one layer), in the example's sky (6 satellites, ground sinks 6 and 7,
hierarchical FedAvg pooled every other round, 2 antennas), satellite 2 lost
after round 0, and writes its start state, per-round logs and final params
to an ``.npz``. The port starts from the same state (``state_from_jax``) on
the same batches. Configs: (none, depth 1), (int8, depth 1) and (int8,
depth 2 with a staleness horizon of 1 window).

Tolerances, as in ``tests/test_torch_fl.py``. Round 0's loss comes before
any exchange, from the same params and tokens: rtol 1e-5. The exchange
itself is bit for bit on equal inputs (``tests/test_torch_groundseg.py``),
but local training is not: the port's matmuls sum in another order, so the
params part in the last bits before they are exchanged. Round 1's loss is
held to rtol 1e-4, the consensus distance to rtol 1e-3 and the final params
to an absolute 2e-4. With int8 an entry whose ``x / s`` lies within those
last bits of a rounding boundary takes the neighbouring code on one side
(on this data, at depth 2: one entry of a leaf of 65 536), and its FedAvg and the
re-encoded downlink then differ by up to one code step of each encode. So
for int8, at most 1e-4 of a leaf's entries may exceed 2e-4, and none may
exceed two code steps of the leaf (2 max|x| / 127). The routing counts in
the logs are exact.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_SATS, N_GROUND = 6, 2
N = N_SATS + N_GROUND
ROUNDS = 2
LOCAL_STEPS = 1
SEQ, ROWS = 16, 2
LOST = 2
CONFIGS = {
    "none_d1": dict(compression="none", pipeline_depth=1, max_staleness_windows=0),
    "int8_d1": dict(compression="int8", pipeline_depth=1, max_staleness_windows=0),
    "int8_d2": dict(compression="int8", pipeline_depth=2, max_staleness_windows=1),
}
LOG_FIELDS = ("delivered", "covered", "unreachable", "alive", "pooled", "carried",
              "dropped", "max_age")


def _setup(archs, adamw, ShapeConfig, scenario):
    cfg = archs.smoke_cfg(archs.get("mamba2-780m")).replace(
        compute_dtype="float32", n_layers=1)
    opt_cfg = adamw.OptConfig(peak_lr=5e-3, warmup_steps=2, decay_steps=100)
    scn = scenario.build_scenario(scenario.ScenarioSpec(
        shells=(scenario.ShellSpec(planes=2, per_plane=N_SATS // 2),), n_ground=N_GROUND,
        steps=4, max_range_km=14_000.0,
    ))
    return cfg, opt_cfg, ShapeConfig("fl", "train", SEQ, ROWS), scn


def _run_kwargs(scn, on_round):
    return dict(sinks=scn.ground_ids, rounds=ROUNDS, alive=None, on_round=on_round,
                antennas=2, payload_bytes=1 << 22)


def _reference(out_path: str) -> None:
    """Child process: the JAX reference on 8 forced host devices."""
    import jax

    from repro.configs import archs
    from repro.constellation import scenario
    from repro.launch import fl_train
    from repro.models.config import ShapeConfig
    from repro.optim import adamw
    from repro_torch.launch.train_fl_constellation import make_batch_fn

    cfg, opt_cfg, shape, scn = _setup(archs, adamw, ShapeConfig, scenario)
    mesh = jax.make_mesh((N,), ("data",))
    start = jax.tree.map(
        np.asarray, fl_train._stack_init(jax.random.PRNGKey(0), cfg, opt_cfg, N)
    )
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(start)
    for path, leaf in flat:
        out["start/" + jax.tree_util.keystr(path)] = leaf
    for name, kw in CONFIGS.items():
        alive = set(range(N))

        def on_round(log):
            if log.round == 0:
                alive.discard(LOST)

        gs_cfg = fl_train.GroundSegConfig(mode="hierarchical", sink_sync_every=2,
                                          quant_impl="ref", **kw)
        state = jax.tree.map(lambda a: jax.numpy.array(a), start)  # donated
        kwargs = dict(_run_kwargs(scn, on_round), alive=alive)
        state, logs = fl_train.run_groundseg_fl(
            cfg, opt_cfg, mesh, N, fl_train.FLConfig(mode="tdm", local_steps=LOCAL_STEPS),
            gs_cfg, scn.plan, state, make_batch_fn(cfg, shape, N, LOCAL_STEPS), **kwargs,
        )
        out[f"{name}/loss"] = np.array([lg.loss for lg in logs])
        out[f"{name}/consensus"] = np.array([lg.consensus for lg in logs])
        for field in LOG_FIELDS:
            out[f"{name}/{field}"] = np.array([getattr(lg, field) for lg in logs])
        flat, _ = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, state["params"]))
        for path, leaf in flat:
            out[f"{name}/params/" + jax.tree_util.keystr(path)] = leaf
    np.savez(out_path, **out)


def _unkeystr(d: dict, prefix: str) -> dict:
    """{prefix + "['a']['b']": leaf} -> nested dict."""
    tree: dict = {}
    for key, leaf in d.items():
        if not key.startswith(prefix):
            continue
        parts = [p.strip("'") for p in key[len(prefix):].strip("[]").split("][")]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_groundseg_fl") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 " + env.get("XLA_FLAGS", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = f"{ROOT / 'src'}:{ROOT / 'tests'}:" + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, __file__, str(out)], capture_output=True, text=True,
        env=env, timeout=900, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _port_run(ref: dict, name: str):
    from repro_torch.configs import archs
    from repro_torch.constellation import scenario
    from repro_torch.launch import fl_train
    from repro_torch.launch.train_fl_constellation import make_batch_fn
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.weights import state_from_jax

    cfg, opt_cfg, shape, scn = _setup(archs, adamw, ShapeConfig, scenario)
    state = state_from_jax(_unkeystr(ref, "start/"), device="cpu")
    alive = set(range(N))

    def on_round(log):
        if log.round == 0:
            alive.discard(LOST)

    gs_cfg = fl_train.GroundSegConfig(mode="hierarchical", sink_sync_every=2,
                                      **CONFIGS[name])
    return fl_train.run(fl_train.GroundSegRun(
        cfg, opt_cfg, N, fl_train.FLConfig(mode="tdm", local_steps=LOCAL_STEPS), gs_cfg,
        scn.plan, state, make_batch_fn(cfg, shape, N, LOCAL_STEPS),
        **dict(_run_kwargs(scn, on_round), alive=alive),
    ))


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_groundseg_run_matches_reference(reference, name):
    from repro_torch.weights import to_numpy

    res = _port_run(reference, name)
    logs = res.logs
    assert res.mode == "groundseg" and len(logs) == ROUNDS
    assert [lg.alive for lg in logs] == [6, 5]
    for field in LOG_FIELDS:
        np.testing.assert_array_equal([getattr(lg, field) for lg in logs],
                                      reference[f"{name}/{field}"], err_msg=field)
    loss = np.array([lg.loss for lg in logs])
    cons = np.array([lg.consensus for lg in logs])
    assert np.isfinite(loss).all() and np.isfinite(cons).all()
    np.testing.assert_allclose(loss[0], reference[f"{name}/loss"][0], rtol=1e-5)
    np.testing.assert_allclose(loss[1:], reference[f"{name}/loss"][1:], rtol=1e-4)
    np.testing.assert_allclose(cons, reference[f"{name}/consensus"], rtol=1e-3)
    want = _unkeystr(reference, f"{name}/params/")
    got = to_numpy(res.state["params"])

    int8 = CONFIGS[name]["compression"] == "int8"

    def compare(g, w, path=""):
        if isinstance(w, dict):
            for k in w:
                compare(g[k], w[k], f"{path}/{k}")
            return
        if not int8:
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-4, err_msg=path)
            return
        gap = np.abs(np.asarray(g, np.float64) - w)
        flipped = int((gap > 2e-4).sum())
        assert flipped <= max(1, w.size // 10_000), (path, flipped)
        assert gap.max() <= 2 * np.abs(w).max() / 127 + 2e-4, (path, gap.max())

    compare(got, want)


def test_pipelined_engine_at_depth1_staleness0_is_the_one_shot_run():
    """The multi-window engine driven with depth 1 and no persistence gives
    the one-shot run_groundseg_fl bit for bit (logs and params), on the smoke
    model with satellite 2 lost after round 0."""
    import torch

    from repro_torch.configs import archs
    from repro_torch.constellation import scenario
    from repro_torch.launch import fl_train
    from repro_torch.launch.train_fl_constellation import make_batch_fn
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.pytree import tree_leaves

    cfg, opt_cfg, shape, scn = _setup(archs, adamw, ShapeConfig, scenario)
    fl_cfg = fl_train.FLConfig(mode="tdm", local_steps=LOCAL_STEPS)
    gs_cfg = fl_train.GroundSegConfig(mode="hierarchical", compression="int8")
    base_rels = list(scn.plan.schedule(antennas=2, payload_bytes=1 << 22).tdm)
    batch_fn = make_batch_fn(cfg, shape, N, LOCAL_STEPS)
    runs = []
    for engine in ("one_shot", "pipelined"):
        state = fl_train._stack_init(0, cfg, opt_cfg, N, device="cpu")
        alive = set(range(N))

        def on_round(log):
            if log.round == 0:
                alive.discard(LOST)

        if engine == "one_shot":
            state, logs = fl_train.run_groundseg_fl(
                cfg, opt_cfg, N, fl_cfg, gs_cfg, scn.plan, state, batch_fn,
                **dict(_run_kwargs(scn, on_round), alive=alive))
        else:
            state, logs = fl_train._run_groundseg_pipelined(
                cfg, opt_cfg, N, fl_cfg, gs_cfg, base_rels, state, batch_fn,
                frozenset(scn.ground_ids), list(range(N_SATS)), ROUNDS, alive,
                on_round, 1)
        runs.append((state, logs))
    (s1, l1), (s2, l2) = runs
    assert l1 == l2
    for a, b in zip(tree_leaves(s1), tree_leaves(s2)):
        assert torch.equal(a, b)


if __name__ == "__main__":
    _reference(sys.argv[1])
