"""The port's ground segment against the JAX reference: routing programs,
the stacked relay / FedAvg / broadcast / pipelined window, and the plain
``quantize_scaled`` / ``dequantize``.

Routing is numpy on both sides and is compared in this process. The
aggregation runs in the reference under ``shard_map``, so a child process
(this file run as a script, with 8 forced XLA host devices) runs it on fixed
seeded numpy buffers with ``quant_impl="ref"`` (the reference's own tests
hold its Pallas kernels bit-identical to those plain versions) and writes
the results to an ``.npz``; the port runs the same inputs stacked on the CPU.
The programs are the example's: 6 satellites and 2 ground sinks (nodes 6
and 7), with all satellites alive and with satellite 2 lost. The pipelined
windows strand satellite 0's payload for one window, so a carried payload is
re-offered with its decay.

Tolerances. Everything is bit for bit: data movement, the int8 relay
(shared scales, codes, int16 sums, the dequantized sink buffers: the
reference's fold ``acc + 1.0 * (z * s)`` compiles to ``fma(z, s, acc)``, and
the port's unit-weight accumulate rounds once the same way), the int8
downlink, regional FedAvg (a true division on both sides) and pooled FedAvg.
The pooled sum is exact in any order here, because two sinks are pooled and
every other row adds an exact 0.0; the reference divides it by a constant,
which XLA compiles to a multiply by the float32 reciprocal, and the port
does the same multiply (with satellite 2 lost the total weight is 7, where a
true division differs in the last bit for about half of the entries). The buffers hold -0.0 entries, which the reference's
``acc + ppermute(..)`` turns into +0.0 on rows that receive nothing.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 8
SINKS = (6, 7)
SATS = tuple(range(6))
LOST = 2                 # the example's lost satellite
STRANDED = 0             # cut off for one window in the pipelined cases
L = 3000                 # ragged: 11.7 blocks of 256
BLOCK = 256
PROGRAMS = ("all", "lost")
WINDOW_CASES = [(1, "none"), (1, "int8"), (2, "none"), (2, "int8")]


def _scenario(scenario_mod):
    """The example's groundseg sky (repro or repro_torch scenario module)."""
    return scenario_mod.build_scenario(scenario_mod.ScenarioSpec(
        shells=(scenario_mod.ShellSpec(planes=2, per_plane=3),), n_ground=2,
        steps=4, max_range_km=14_000.0,
    ))


def _slots(scenario_mod):
    return list(_scenario(scenario_mod).plan.schedule(
        antennas=2, payload_bytes=1 << 22).tdm)


def _programs(routing, rels, name):
    live = set(range(N)) - ({LOST} if name == "lost" else set())
    rr = [r.restrict(live) for r in rels]
    table = routing.earliest_delivery_routes(
        rr, N, SINKS, sources=[v for v in SATS if v in live])
    up = routing.build_relay_program(rr, N, SINKS, table=table)
    return up, routing.build_broadcast_program(rr, N, SINKS)


def _windows(routing, rels, depth):
    """Three windows: satellite 0 cut off (its payload carries), all back,
    then satellite 2 lost."""
    router = routing.MultiWindowRouter(N, SINKS, max_staleness_windows=1,
                                       pipeline_depth=depth)
    cut = [r.restrict(set(range(N)) - {STRANDED}) for r in rels]
    return [router.plan_window(cut, alive=range(N)),
            router.plan_window(rels, alive=range(N)),
            router.plan_window(rels, alive=set(range(N)) - {LOST})]


def _inputs():
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((N, L)) * rng.uniform(0.05, 4.0, (N, 1))).astype(np.float32)
    x[:, ::97] = -0.0
    x[3, 1000:1300] = 0.0
    tree = {
        "a": rng.standard_normal((N, 700)).astype(np.float32),
        "b": {"c": rng.standard_normal((N, 5, 300)).astype(np.float32),
              "d": (rng.standard_normal((N, 1500)) * 0.01).astype(np.float32)},
    }
    tree["a"][:, ::31] = -0.0
    return x, tree


def _tree_items(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _tree_items(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _reference(out_path: str) -> None:
    """Child process: the reference aggregation on 8 forced host devices."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.constellation import scenario
    from repro.core import fused
    from repro.groundseg import aggregation, routing
    from repro.groundseg.aggregation import _mask
    from repro.kernels.tdm_compress import ref as q_ref

    mesh = Mesh(np.array(jax.devices()[:N]), ("node",))

    def spmd(f, *args):
        def body(*a):
            out = f(*jax.tree.map(lambda t: t[0], a))
            return jax.tree.map(lambda t: t[None], out)

        return jax.tree.map(np.asarray, jax.jit(shard_map(
            body, mesh=mesh, in_specs=P("node"), out_specs=P("node"), check_rep=False,
        ))(*args))

    def int8_parts(v, up):
        # aggregation.py relay_uplink's int8 channel, up to the final dequant
        idx = jax.lax.axis_index("node")
        sources = sorted({s for sends in up.slot_sends for s, _ in sends})
        s_shared = jax.lax.pmax(q_ref.blockwise_scales_ref(v, block=BLOCK), "node")
        q = q_ref.quantize_scaled_ref(v, s_shared, block=BLOCK)
        z = jnp.where(jnp.asarray(_mask(sources, N))[idx], q, 0).astype(jnp.int16)
        for sends in up.slot_sends:
            if not sends:
                continue
            is_sender = jnp.asarray(_mask([s for s, _ in sends], N))[idx]
            z_pre = z
            z = jnp.where(is_sender, jnp.int16(0), z)
            for batch in routing.permutation_batches(sends):
                z = z + jax.lax.ppermute(z_pre, "node", list(batch))
        return s_shared, q, z

    x, tree = _inputs()
    rels = _slots(scenario)
    out = {}
    for name in PROGRAMS:
        up, down = _programs(routing, rels, name)

        def cases(v, t):
            # every one-shot case of one program in one compiled function
            b, res = {"float32": v}, {}
            for comp in ("none", "int8"):
                res[f"relay_{comp}"] = aggregation.relay_uplink(
                    b, up, "node", compression=comp, block=BLOCK, quant_impl="ref")
                res[f"bcast_{comp}"] = aggregation.broadcast_downlink(
                    b, down, "node", compression=comp, block=BLOCK, quant_impl="ref")
            res["int8_scales"], res["int8_q"], res["int8_z"] = int8_parts(v, up)
            for pool in (True, False):
                res[f"fedavg_{pool}"] = aggregation.sink_fedavg(b, up, "node", pool=pool)
                for comp in ("none", "int8"):
                    res[f"round_{comp}_{pool}"] = aggregation.groundseg_round(
                        t, up, down, "node", pool=pool, compression=comp,
                        quant_impl="ref")
            return res

        for key, leaf in _tree_items(spmd(cases, x, tree)):
            out[f"{name}/{key.removesuffix('/float32')}"] = leaf
    spec = fused.cached_spec(jax.tree.map(lambda a: a[0], tree))
    zeros = np.zeros((N, spec.padded_size("float32")), np.float32)
    for depth, comp in WINDOW_CASES:
        wps = _windows(routing, rels, depth)

        def windows(t, c, p):
            # the three windows threaded through carry and pending
            res = {}
            for w, wp in enumerate(wps):
                t, c, p = aggregation.pipelined_window_round(
                    t, c, p, wp, "node", pool=(w % 2 == 0), staleness_decay=0.5,
                    compression=comp, quant_impl="ref")
                res[str(w)] = {"params": t, "carry": c, "pending": p}
            return res

        got = spmd(windows, tree, {"float32": zeros}, {"float32": zeros})
        for key, leaf in _tree_items(got):
            out[f"window{depth}_{comp}/{key.removesuffix('/float32')}"] = leaf
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_groundseg") / "ref.npz"
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


def _t(a):
    import torch

    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    return {k: (_tree_t(v) if isinstance(v, dict) else _t(v)) for k, v in tree.items()}


def _tree_np(tree):
    return dict(_tree_items({k: (_tree_np(v) if isinstance(v, dict) else v.numpy())
                             for k, v in tree.items()}))


def _bits(got, want, what=""):
    """Equal bit patterns (so -0.0 differs from +0.0); a NaN equals any NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape)
    if got.dtype.kind == "f":
        nan = np.isnan(got)
        assert (nan == np.isnan(want)).all(), (what, "NaN positions differ")
        got, want = np.where(nan, 0, got), np.where(nan, 0, want)
        got, want = got.view(np.uint32 if got.itemsize == 4 else np.uint16), want.view(
            np.uint32 if want.itemsize == 4 else np.uint16)
    bad = np.nonzero(got != want)
    assert bad[0].size == 0, (what, bad[0][:5], bad[-1][:5])


@pytest.fixture(scope="module")
def port_rels():
    from repro_torch.constellation import scenario

    return _slots(scenario)


# ---------------------------------------------------------------------------
# routing (numpy on both sides, compared in process)
# ---------------------------------------------------------------------------

def _relay_fields(up):
    return (up.n_nodes, up.sinks, up.slot_sends, up.delivered, up.unreachable, up.residual)


def _bcast_fields(down):
    return (down.n_nodes, down.sinks, down.slot_sends, down.covered, down.receive_slot)


@pytest.mark.parametrize("name", PROGRAMS)
def test_relay_and_broadcast_programs_match_reference(port_rels, name):
    from repro.constellation import scenario as j_scenario
    from repro.groundseg import routing as j_routing
    from repro_torch.groundseg import routing

    up, down = _programs(routing, port_rels, name)
    j_up, j_down = _programs(j_routing, _slots(j_scenario), name)
    assert _relay_fields(up) == _relay_fields(j_up)
    assert _bcast_fields(down) == _bcast_fields(j_down)
    assert up.delivered_count() == len(SATS) - (name == "lost")
    for prog, j_prog in ((up, j_up), (down, j_down)):
        assert routing.program_batch_count(prog) == j_routing.program_batch_count(j_prog)
        for sends in prog.slot_sends:
            assert routing.permutation_batches(sends) == j_routing.permutation_batches(sends)


@pytest.mark.parametrize("depth", [1, 2])
def test_window_programs_match_reference(port_rels, depth):
    from repro.constellation import scenario as j_scenario
    from repro.groundseg import routing as j_routing
    from repro_torch.groundseg import routing

    got = _windows(routing, port_rels, depth)
    want = _windows(j_routing, _slots(j_scenario), depth)
    for wp, j_wp in zip(got, want):
        assert _relay_fields(wp.uplink) == _relay_fields(j_wp.uplink)
        assert (wp.downlink is None) == (j_wp.downlink is None)
        if wp.downlink is not None:
            assert _bcast_fields(wp.downlink) == _bcast_fields(j_wp.downlink)
        for field in ("window", "lagged_downlink", "injected", "ages", "delivered_ages",
                      "residual", "dropped"):
            assert getattr(wp, field) == getattr(j_wp, field), field
    assert got[0].residual == {STRANDED: 0} and got[1].ages[STRANDED] == 1


def test_expected_collectives_match_reference(port_rels):
    from repro.constellation import scenario as j_scenario
    from repro.groundseg import aggregation as j_agg
    from repro.groundseg import routing as j_routing
    from repro_torch.groundseg import aggregation, routing

    j_rels = _slots(j_scenario)
    for name in PROGRAMS:
        up, down = _programs(routing, port_rels, name)
        j_up, j_down = _programs(j_routing, j_rels, name)
        for comp in ("none", "int8"):
            for pool in (True, False):
                assert aggregation.expected_collectives(
                    up, down, 2, compression=comp, pool=pool
                ) == j_agg.expected_collectives(j_up, j_down, 2, compression=comp, pool=pool)
    for depth in (1, 2):
        for wp, j_wp in zip(_windows(routing, port_rels, depth),
                            _windows(j_routing, j_rels, depth)):
            assert aggregation.expected_window_collectives(wp, 1, compression="int8") == \
                j_agg.expected_window_collectives(j_wp, 1, compression="int8")


# ---------------------------------------------------------------------------
# aggregation against the reference under shard_map
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", PROGRAMS)
def test_relay_uplink_bitwise(ref, port_rels, name):
    from repro_torch.core import tdm
    from repro_torch.groundseg import aggregation, routing

    x, _ = _inputs()
    up, _ = _programs(routing, port_rels, name)
    for comp in ("none", "int8"):
        before = (tdm.gather_count(), aggregation.reduction_count())
        got = aggregation.relay_uplink({"float32": _t(x)}, up, compression=comp, block=BLOCK)
        issued = (tdm.gather_count() - before[0], aggregation.reduction_count() - before[1])
        _bits(got["float32"].numpy(), ref[f"{name}/relay_{comp}"], comp)
        want = aggregation.expected_collectives(up, None, 1, compression=comp, pool=False)
        assert issued == (want["collective-permute"], want["all-reduce"])


@pytest.mark.slow
@pytest.mark.parametrize("name", PROGRAMS)
def test_int8_relay_scales_codes_and_sums_bitwise(ref, port_rels, name):
    from repro_torch.groundseg import aggregation, routing
    from repro_torch.kernels.tdm_compress import ops

    x, _ = _inputs()
    up, _ = _programs(routing, port_rels, name)
    s, z = aggregation.int8_uplink_sums(_t(x), up, block=BLOCK)
    for r in range(N):      # the all-node max: every node holds the same scales
        _bits(s.numpy(), ref[f"{name}/int8_scales"][r], "scales")
    _bits(ops.quantize_scaled(_t(x), s, block=BLOCK).numpy(), ref[f"{name}/int8_q"], "codes")
    _bits(z.numpy(), ref[f"{name}/int8_z"], "int16 sums")


@pytest.mark.slow
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("name", PROGRAMS)
def test_sink_fedavg_bitwise(ref, port_rels, name, pool):
    from repro_torch.groundseg import aggregation, routing

    x, _ = _inputs()
    up, _ = _programs(routing, port_rels, name)
    got = aggregation.sink_fedavg({"float32": _t(x)}, up, pool=pool)["float32"].numpy()
    _bits(got, ref[f"{name}/fedavg_{pool}"], f"pool={pool}")
    _bits(got[list(SATS)], x[list(SATS)], "satellite rows untouched")
    if pool:
        _bits(got[SINKS[0]], got[SINKS[1]], "pooled sinks agree")


@pytest.mark.slow
@pytest.mark.parametrize("name", PROGRAMS)
def test_broadcast_downlink_bitwise(ref, port_rels, name):
    from repro_torch.groundseg import aggregation, routing

    x, _ = _inputs()
    _, down = _programs(routing, port_rels, name)
    for comp in ("none", "int8"):
        got = aggregation.broadcast_downlink({"float32": _t(x)}, down, compression=comp,
                                             block=BLOCK)
        _bits(got["float32"].numpy(), ref[f"{name}/bcast_{comp}"], comp)


@pytest.mark.slow
@pytest.mark.parametrize("comp", ["none", "int8"])
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("name", PROGRAMS)
def test_groundseg_round_bitwise(ref, port_rels, name, pool, comp):
    from repro_torch.groundseg import aggregation, routing

    _, tree = _inputs()
    up, down = _programs(routing, port_rels, name)
    inp = _tree_t(tree)
    out = aggregation.groundseg_round(inp, up, down, pool=pool, compression=comp)
    for key, leaf in _tree_np(out).items():
        _bits(leaf, ref[f"{name}/round_{comp}_{pool}/{key}"], key)
    # the round writes into the caller's tensors and returns them
    assert out["a"] is inp["a"] and out["b"]["c"] is inp["b"]["c"]


@pytest.mark.slow
@pytest.mark.parametrize("depth,comp", WINDOW_CASES)
def test_pipelined_windows_bitwise(ref, port_rels, depth, comp):
    """Three windows threaded through carry and pending, pooled and
    regional in turn: params, carry and pending bit for bit."""
    import torch

    from repro_torch.core import fused
    from repro_torch.groundseg import aggregation, routing

    _, tree = _inputs()
    params = _tree_t(tree)
    spec = fused.cached_spec(params)
    carry = aggregation.stacked_zero_buffers(spec, N)
    pend = aggregation.stacked_zero_buffers(spec, N)
    for w, wp in enumerate(_windows(routing, port_rels, depth)):
        params, carry, pend = aggregation.pipelined_window_round(
            params, carry, pend, wp, pool=(w % 2 == 0), staleness_decay=0.5,
            compression=comp)
        tag = f"window{depth}_{comp}/{w}"
        for key, leaf in _tree_np(params).items():
            _bits(leaf, ref[f"{tag}/params/{key}"], f"{tag} {key}")
        _bits(carry["float32"].numpy(), ref[f"{tag}/carry"], f"{tag} carry")
        _bits(pend["float32"].numpy(), ref[f"{tag}/pending"], f"{tag} pending")
        if w == 0:
            assert bool(carry["float32"][STRANDED].any()), "stranded payload not carried"
    assert isinstance(params["a"], torch.Tensor)


# ---------------------------------------------------------------------------
# plain versions of the kernels against the reference
# ---------------------------------------------------------------------------

def _edge_rows(seed, rows, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, n)) * rng.uniform(0.1, 5.0, (rows, 1))).astype(np.float32)
    m = rng.random((rows, n))
    x[m < 0.03] = np.nan
    x[(m >= 0.03) & (m < 0.06)] = np.inf
    x[(m >= 0.06) & (m < 0.09)] = -np.inf
    x[(m >= 0.09) & (m < 0.12)] = -0.0
    return x


@pytest.mark.parametrize("rows,n,block", [(3, 1000, 128), (8, 2049, 256), (2, 1, 64),
                                          (4, 4096, 1024)])
def test_quantize_scaled_ref_shared_and_per_row_bitwise(rows, n, block):
    """Shared (nb,) and per-row (rows, nb) scales, NaN/inf payloads, a NaN
    and an inf scale: the port's plain version equals the reference's
    jitted ``quantize_scaled_ref`` and its Pallas kernel in interpret mode,
    row by row."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.tdm_compress import ops as q_ops
    from repro.kernels.tdm_compress import ref as q_ref
    from repro_torch.kernels.tdm_compress import ref

    x = _edge_rows(n + rows, rows, n)
    nb = -(-n // block)
    rng = np.random.default_rng(n)
    per_row = (rng.uniform(0.01, 2.0, (rows, nb))).astype(np.float32)
    per_row[0, 0] = np.nan
    if nb > 1:
        per_row[-1, 1] = np.inf
    shared = per_row.max(axis=0)       # NaN-free max of the finite ones
    shared[0] = np.float32(0.3)
    jit_ref = jax.jit(q_ref.quantize_scaled_ref, static_argnames=("block",))
    got_shared = ref.quantize_scaled_ref(_t(x), _t(shared), block).numpy()
    got_rows = ref.quantize_scaled_ref(_t(x), _t(per_row), block).numpy()
    for r in range(rows):
        want = np.asarray(jit_ref(jnp.asarray(x[r]), jnp.asarray(shared), block=block))
        _bits(got_shared[r], want, f"shared row {r}")
        _bits(got_shared[r], np.asarray(q_ops.quantize_scaled(
            jnp.asarray(x[r]), jnp.asarray(shared), block=block, interpret=True)), "pallas")
        want = np.asarray(jit_ref(jnp.asarray(x[r]), jnp.asarray(per_row[r]), block=block))
        _bits(got_rows[r], want, f"per-row row {r}")
        _bits(got_rows[r], np.asarray(q_ops.quantize_scaled(
            jnp.asarray(x[r]), jnp.asarray(per_row[r]), block=block, interpret=True)),
            "pallas per-row")


@pytest.mark.parametrize("shape,block", [((3, 700), 128), ((2049,), 256), ((4, 5, 300), 1024)])
def test_dequantize_payload_bitwise(shape, block):
    """``ops.dequantize_payload`` (and ``dequantize_ref`` with shared and
    per-row scales) equal the reference's ``dequantize_payload`` in interpret
    mode and its ``dequantize_ref``."""
    import jax.numpy as jnp

    from repro.kernels.tdm_compress import ops as q_ops
    from repro.kernels.tdm_compress import ref as q_ref
    from repro_torch.kernels.tdm_compress import ops, ref

    x = _edge_rows(block, 1, int(np.prod(shape)))[0].reshape(shape)
    q, s = ops.quantize(_t(x).reshape(-1), block=block)
    j_q, j_s, _ = q_ops.quantize_payload(jnp.asarray(x), block=block, interpret=True)
    _bits(q.numpy(), np.asarray(j_q), "codes")
    _bits(s.numpy(), np.asarray(j_s), "scales")
    _bits(ops.dequantize_payload(q, s, shape, block=block).numpy(),
          np.asarray(q_ops.dequantize_payload(j_q, j_s, shape, block=block, interpret=True)),
          "payload")
    rows = _edge_rows(7, 3, 1000)
    q2, s2 = ref.quantize_ref(_t(rows), 128)
    shared = s2.amax(dim=0)
    for scales in (s2, shared):
        got = ref.dequantize_ref(q2, scales, 128).numpy()
        for r in range(3):
            sr = scales[r] if scales.dim() == 2 else scales
            _bits(got[r], np.asarray(q_ref.dequantize_ref(
                jnp.asarray(q2[r].numpy()), jnp.asarray(sr.numpy()), 128)), f"row {r}")


@pytest.mark.parametrize("qtype", ["int16", "int8"])
def test_unit_weight_accumulate_is_the_fused_reference(qtype):
    """``dequant_acc_ref(q, s, acc, None)`` equals the jitted reference's
    ``dequant_acc_ref(q, s, acc, 1.0)``, which XLA compiles to one fused
    multiply-add, over accumulators from 1e-8 to 1e8 times the products
    (where float64 rounding alone would round twice), inf scales and NaN.

    The reference's other path, its Pallas kernel (here in interpret mode),
    takes the weight as an operand and rounds the product first: it equals
    the port's two-rounding ``dequant_acc_ref(q, s, acc, 1.0)`` bit for bit,
    and differs from the one-rounding fold by at most half an ulp of the
    product plus one ulp of the result (the product's rounding, carried
    through the sum's)."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.tdm_compress import ops as q_ops
    from repro.kernels.tdm_compress import ref as q_ref
    from repro_torch.kernels.tdm_compress import ref

    rng = np.random.default_rng(5)
    rows, n, block = 4, 5000, 256
    nb = -(-n // block)
    hi = 762 if qtype == "int16" else 127
    q = rng.integers(-hi, hi + 1, (rows, n)).astype(qtype)
    s = rng.uniform(1e-4, 1e-1, (rows, nb)).astype(np.float32)
    s[1, 3] = np.inf
    s[2, 4] = np.nan
    acc = (rng.standard_normal((rows, n))
           * 10.0 ** rng.uniform(-8, 8, (rows, n))).astype(np.float32)
    acc[0, :50] = -0.0
    fold = jax.jit(lambda q_, s_, a_: q_ref.dequant_acc_ref(q_, s_, a_, jnp.float32(1.0),
                                                             block=block))
    got = ref.dequant_acc_ref(_t(q), _t(s), _t(acc), None, block).numpy()
    two = ref.dequant_acc_ref(_t(q), _t(s), _t(acc), 1.0, block).numpy()
    prod = ref.dequantize_ref(_t(q), _t(s), block).numpy()
    for r in range(rows):
        _bits(got[r], np.asarray(fold(jnp.asarray(q[r]), jnp.asarray(s[r]),
                                      jnp.asarray(acc[r]))), f"row {r}")
        pallas = np.asarray(q_ops.dequant_accumulate(
            jnp.asarray(q[r]), jnp.asarray(s[r]), jnp.asarray(acc[r]), jnp.float32(1.0),
            block=block, interpret=True))
        _bits(two[r], pallas, f"pallas row {r}")
        fin = np.isfinite(got[r])
        _bits(got[r][~fin], pallas[~fin], f"non-finite row {r}")
        gap = np.abs(got[r][fin].astype(np.float64) - pallas[fin])
        bound = (0.5 * np.spacing(np.abs(prod[r][fin]))
                 + np.spacing(np.maximum(np.abs(got[r][fin]), np.abs(pallas[fin]))))
        assert (gap <= bound).all(), f"row {r}: fused vs Pallas beyond the bound"
        assert (gap > 0).any(), f"row {r}: the two paths should differ somewhere"


# ---------------------------------------------------------------------------
# port-internal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("comp", ["none", "int8"])
@pytest.mark.parametrize("pool", [True, False])
def test_pipelined_depth1_staleness0_equals_one_shot(port_rels, pool, comp):
    """Depth 1 with no persistence through the pipelined engine is the
    one-shot round, bit for bit, and carries nothing."""
    import torch

    from repro_torch.core import fused
    from repro_torch.groundseg import aggregation, routing
    from repro_torch.pytree import tree_map

    _, tree = _inputs()
    params = _tree_t(tree)
    spec = fused.cached_spec(params)
    router = routing.MultiWindowRouter(N, SINKS, max_staleness_windows=0, pipeline_depth=1)
    for alive in (set(range(N)), set(range(N)) - {LOST}):
        wp = router.plan_window(port_rels, alive=alive)
        up, down = _programs(routing, port_rels, "all" if len(alive) == N else "lost")
        one_shot = aggregation.groundseg_round(tree_map(torch.clone, params), up, down,
                                               pool=pool, compression=comp)
        got, carry, pend = aggregation.pipelined_window_round(
            tree_map(torch.clone, params), aggregation.stacked_zero_buffers(spec, N),
            aggregation.stacked_zero_buffers(spec, N), wp, pool=pool, compression=comp)
        for key, leaf in _tree_np(got).items():
            _bits(leaf, _tree_np(one_shot)[key], key)
        assert not carry["float32"].any()
        params = got


def test_sink_rows_unchanged_by_local_training():
    """Sinks skip local training: their params, moments and step come out
    bit-identical, and the satellites' rows equal a run that trains all."""
    import torch

    from repro_torch.configs import archs
    from repro_torch.launch import fl_train
    from repro_torch.launch.train_fl_constellation import make_batch_fn
    from repro_torch.models import registry
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.pytree import tree_leaves, tree_map

    cfg = archs.smoke_cfg(archs.get("mamba2-780m")).replace(n_layers=1)
    opt = adamw.OptConfig(peak_lr=5e-3, warmup_steps=2, decay_steps=100)
    state = fl_train._stack_init(0, cfg, opt, N, device="cpu")
    # give the sinks their own params, as after a FedAvg
    for leaf in tree_leaves(state["params"]):
        leaf[list(SINKS)] += 0.25
    batch = fl_train.batch_to_device(
        make_batch_fn(cfg, ShapeConfig("fl", "train", 16, 2), N, local_steps=1)(0), "cpu")
    start = tree_map(torch.clone, state)
    full = tree_map(torch.clone, state)
    losses = fl_train.local_train(registry.bundle(cfg), opt, state, batch, 1, rows=SATS)
    fl_train.local_train(registry.bundle(cfg), opt, full, batch, 1)
    assert torch.isnan(losses[list(SINKS)]).all() and torch.isfinite(losses[list(SATS)]).all()
    for got, was, ref_all in zip(tree_leaves(state), tree_leaves(start), tree_leaves(full)):
        assert torch.equal(got[list(SINKS)], was[list(SINKS)])
        assert torch.equal(got[list(SATS)], ref_all[list(SATS)])


BAD_CONFIGS = [
    dict(mode="gossip"), dict(compression="topk"), dict(pipeline_depth=3),
    dict(pipeline_depth=0), dict(max_staleness_windows=-1), dict(staleness_decay=0.0),
    dict(staleness_decay=1.5),
]
GOOD_CONFIGS = [
    dict(), dict(mode="hierarchical", sink_sync_every=3), dict(compression="int8"),
    dict(pipeline_depth=2), dict(max_staleness_windows=2, staleness_decay=1.0),
    dict(mode="hierarchical", sink_sync_every=0),
]


@pytest.mark.parametrize("kwargs", BAD_CONFIGS + GOOD_CONFIGS)
def test_groundseg_config_validation_matches_reference(kwargs):
    from repro.launch.fl_train import GroundSegConfig as JConfig
    from repro_torch.launch.fl_train import GroundSegConfig

    def make(cls):
        try:
            return cls(**kwargs)
        except ValueError as exc:
            return str(exc)

    got, want = make(GroundSegConfig), make(JConfig)
    if isinstance(want, str):
        assert got == want
        return
    assert got.pipelined == want.pipelined
    assert [got.pool_round(r) for r in range(6)] == [want.pool_round(r) for r in range(6)]


def test_launcher_runs_groundseg_on_cpu(capsys):
    """``--mode groundseg --device cpu`` through the launcher's ``main``:
    satellite 2 lost after round 0, every live satellite delivered."""
    from repro_torch import kernels
    from repro_torch.launch import train_fl_constellation as tfc

    before = kernels.launch_counts()
    tfc.main(["--mode", "groundseg", "--device", "cpu", "--compression", "int8",
              "--rounds", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "delivered 6/6" in out and "delivered 5/5" in out
    assert "satellite 2 lost" in out and "pooled" in out and "regional" in out
    assert kernels.launch_counts() == before    # CPU tensors never reach a kernel
    with pytest.raises(SystemExit):
        tfc.main(["--mode", "groundseg", "--device", "cpu", "--compression", "topk"])


if __name__ == "__main__":
    _reference(sys.argv[1])
