"""The port's schedule-fuzz differential harness and the liveness stall
replays, on the CPU: twins of ``tests/test_differential.py`` (``check_case``,
its seeded fuzz, the certifier counterexamples, the compiled seams) and of
the stall-replay half of ``tests/test_liveness.py``.

For random TASKGRAPHs x the four dispatch policies x random host/disk
capacities, every buildable plan of the port runs through the port's
executors — a replay of the port simulator's schedule, the threaded
runtime, ``mode='fixed'``, the compiled backend under the compiler's seam
stamps and with every seam forced inline or threaded, and a shared-pool
lane — and each must give the oracle's bytes: the port's ``eval_taskgraph``
and the reference's, on the same integer-valued inputs (every op is then
exact, so the comparison is byte equality, no tolerance).

:func:`confirm_hazard` is the port of ``helpers.confirm_hazard``: a
certifier finding's witness replayed through the port's interpreter, or
for a liveness finding through the port's ``replay_stall``. Other port
tests import it and :func:`to_port` from here.
"""
import random as pyrandom

import numpy as np
import pytest
import torch

from repro.core.runtime import eval_taskgraph as ref_eval
from repro_torch.core import (BuildConfig, HostPool, MemgraphOOM, TaskGraph,
                              TensorSpec, build_memgraph, certify, lockcheck)
from repro_torch.core.analyze import (PlanHazard, recover_residencies,
                                      replay_occupancy)
from repro_torch.core.dispatch import POLICY_NAMES
from repro_torch.core.liveness import (ATOMIC_ADMISSION_STALL,
                                       DISK_CREDIT_STALL, LEASE_FLOOR_STALL,
                                       REVOCATION_CYCLE, LeaseSpec,
                                       PoolConfig, certify_progress,
                                       default_pool_config)
from repro_torch.core.memgraph import DepKind, MemGraph
from repro_torch.core.runtime import (TurnipRuntime, eval_taskgraph,
                                      replay_stall, run_in_order)
from repro_torch.core.simulate import HardwareModel, simulate

from helpers import fig3_taskgraph, graph_inputs, random_taskgraph

torch.set_num_threads(1)

UNITS = dict(size_fn=lambda v: 1)
ARB_POLICIES = ("static", "demand", "priority")
HOST_CAPS = (None, 1, 2, 3)
DISK_CAPS = (None, 0, 2, 4, 50)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


def to_port(ref_tg) -> TaskGraph:
    """The reference's TASKGRAPH rebuilt vertex for vertex in the port."""
    tg = TaskGraph()
    for tid in sorted(ref_tg.vertices):
        v = ref_tg.vertices[tid]
        tg.add(v.kind.value, v.device, v.inputs,
               TensorSpec(v.out.shape, v.out.dtype), op=v.op,
               params=dict(v.params), flops=v.flops, name=v.name,
               streaming=v.streaming)
    return tg


def port_inputs(tg, seed: int = 0) -> dict:
    """``helpers.int_inputs`` for a TASKGRAPH of either package: the same
    integer-valued float64 draw, keyed by the same tids."""
    rng = np.random.default_rng(seed)
    return {t: rng.integers(-3, 4, v.out.shape).astype(np.float64)
            for t, v in tg.vertices.items() if v.kind.value == "input"}


def _assert_equal(out, ref, what):
    assert set(out) == set(ref)
    for k in ref:
        got = out[k].cpu()
        want = ref[k].cpu() if isinstance(ref[k], torch.Tensor) \
            else torch.from_numpy(np.asarray(ref[k]))
        assert torch.equal(got, want), f"{what}: output {k}"


def confirm_hazard(tg, res, hazard, *, seed: int = 0, cert=None) -> str:
    """Dynamically confirm a certifier finding on the port: a race or
    divergence witness replays through :func:`run_in_order`, an occupancy
    witness through ``replay_occupancy``, a liveness (``stall``) witness
    through :func:`replay_stall` against a real HostPool. ``tg`` is the
    port's TASKGRAPH. Returns how the witness manifested; raises
    ``AssertionError`` if the replay stays healthy."""
    assert hazard.confirmable, f"hazard is not replay-falsifiable: {hazard}"
    if hazard.witness_kind == "stall":
        if cert is None:
            cert = res.liveness_certificate
        assert cert is not None, "stall replay needs the certificate"
        mg = getattr(res, "memgraph", res) if res is not None else None
        return replay_stall(hazard, cert, mg)
    assert hazard.witness, f"hazard carries no witness schedule: {hazard}"
    if hazard.witness_kind == "occupancy":
        occ = replay_occupancy(res.memgraph, hazard.witness,
                               tier=hazard.tier)
        peak = max(occ[:hazard.prefix])
        assert hazard.capacity is not None and peak > hazard.capacity, \
            f"witness prefix peaks at {peak} ≤ capacity {hazard.capacity}"
        return f"occupancy {peak} > capacity {hazard.capacity}"
    inputs = port_inputs(tg, seed)
    ref = eval_taskgraph(tg, inputs, **CPU)
    try:
        out = run_in_order(tg, res, inputs, list(hazard.witness), **CPU)
    except Exception as e:                     # RaceError, KeyError, ...
        return f"raised {type(e).__name__}"
    for k in ref:
        if not torch.equal(out[k], ref[k]):
            return f"diverged from the oracle on output {k}"
    raise AssertionError(f"witness replay did not confirm hazard: {hazard}")


def check_case(ref_tg, seed: int, host_cap, disk_cap, *,
               policies=POLICY_NAMES) -> str:
    """One fuzz case on the port; returns 'oom' | 'host' | 'disk'."""
    tg = to_port(ref_tg)
    cfg = BuildConfig(capacity=3, host_capacity=host_cap,
                      disk_capacity=disk_cap, rng_seed=seed, **UNITS)
    try:
        res = build_memgraph(tg, cfg)
    except MemgraphOOM as e:
        assert any(t in str(e) for t in ("device", "host tier", "disk tier"))
        return "oom"
    mg = res.memgraph
    mg.validate(check_races=True, host_capacity=host_cap,
                disk_capacity=disk_cap)
    cert = certify(mg, host_capacity=host_cap, disk_capacity=disk_cap)
    assert cert.ok, f"built plan failed certification:\n{cert.summary()}"

    inputs = graph_inputs(ref_tg, seed)
    ref = eval_taskgraph(tg, inputs, **CPU)       # the port's oracle ...
    _assert_equal(ref, ref_eval(ref_tg, inputs), "port oracle")  # ... = ref
    hw = HardwareModel(transfer_jitter=0.5, compute_jitter=0.2, seed=seed)
    for policy in policies:
        sim = simulate(mg, hw, mode="nondet", policy=policy)
        order = mg.topo_order(key=lambda m: (sim.start_at[m], m))
        _assert_equal(run_in_order(tg, res, inputs, order, **CPU), ref,
                      f"sim-replay/{policy}")
        rr = TurnipRuntime(tg, res, mode="nondet", policy=policy,
                           seed=seed, **CPU).run(inputs)
        _assert_equal(rr.outputs, ref, f"threaded/{policy}")
    rr = TurnipRuntime(tg, res, mode="fixed", policy="fixed", seed=seed,
                       **CPU).run(inputs)
    _assert_equal(rr.outputs, ref, "threaded/fixed-mode")

    # compiled lane: every vertex accounted to exactly one executor
    for policy in policies:
        rr = TurnipRuntime(tg, res, mode="nondet", policy=policy, seed=seed,
                           exec_backend="compiled", **CPU).run(inputs)
        _assert_equal(rr.outputs, ref, f"compiled/{policy}")
        assert rr.n_compiled + rr.n_interpreted == len(mg.vertices)
        assert rr.n_inline + rr.n_threaded == rr.n_interpreted
    # forced-backend lane: every seam on one backend
    for backend in ("inline", "threaded"):
        for policy in policies:
            rr = TurnipRuntime(tg, res, mode="nondet", policy=policy,
                               seed=seed, exec_backend="compiled",
                               seam_backend=backend, **CPU).run(inputs)
            _assert_equal(rr.outputs, ref, f"compiled/{backend}/{policy}")
            assert rr.n_inline + rr.n_threaded == rr.n_interpreted
            if backend == "inline":
                assert rr.n_threaded == 0
            else:
                assert rr.n_inline == 0

    # shared-pool lane: arbitration moves grants, never the bytes
    if host_cap is not None and res.n_spills:
        rngp = pyrandom.Random(seed * 31 + 7)
        pool = HostPool(1 << 20, policy=rngp.choice(ARB_POLICIES))
        mem_lease = pool.lease("memgraph", min_bytes=rngp.choice(
            (0, 1 << 16)), weight=1.0, priority=1)
        other = pool.lease("kv", weight=rngp.random() * 4 + 0.1, priority=2)
        other.try_charge(rngp.randrange(1 << 19))
        for policy in ("random", "critical-path"):
            for exec_backend in ("interpreted", "compiled"):
                rr = TurnipRuntime(tg, res, mode="nondet", policy=policy,
                                   seed=seed, host_lease=mem_lease,
                                   exec_backend=exec_backend,
                                   **CPU).run(inputs)
                _assert_equal(rr.outputs, ref,
                              f"pooled/{exec_backend}/{policy}")
                assert pool.used_bytes == other.used, \
                    "runtime store release did not drain its lease"
        assert mem_lease.peak > 0
    return "disk" if res.n_loads else "host"


def _fuzz_case(seed: int):
    rng = pyrandom.Random(1000 + seed)
    tg = random_taskgraph(rng)
    host_cap = rng.choice(HOST_CAPS)
    disk_cap = rng.choice(DISK_CAPS) if host_cap is not None else None
    return tg, host_cap, disk_cap


@pytest.mark.parametrize("seed", range(14))
def test_fuzz_seeded_differential(seed):
    """The reference's pinned-seed sweep, one case per seed."""
    tg, host_cap, disk_cap = _fuzz_case(seed)
    check_case(tg, seed, host_cap, disk_cap)


def test_fuzz_sweep_covers_disk_and_rejection():
    """The sweep exercises real disk-tier plans and a compile-time
    rejection, as the reference's does (planner only: cheap)."""
    outcomes = {"oom": 0, "host": 0, "disk": 0}
    for seed in range(14):
        ref_tg, host_cap, disk_cap = _fuzz_case(seed)
        try:
            res = build_memgraph(to_port(ref_tg), BuildConfig(
                capacity=3, host_capacity=host_cap, disk_capacity=disk_cap,
                rng_seed=seed, **UNITS))
        except MemgraphOOM:
            outcomes["oom"] += 1
            continue
        outcomes["disk" if res.n_loads else "host"] += 1
    assert outcomes["disk"] >= 3, outcomes
    assert outcomes["oom"] >= 1, outcomes


def test_certifier_counterexamples_feed_the_harness():
    """Delete one safe-overwrite MEM edge of a built plan: the witness the
    port's certifier emits replays to a RaceError or a divergence through
    the port's interpreter."""
    n_confirmed = 0
    for seed in range(8):
        ref_tg = random_taskgraph(pyrandom.Random(1000 + seed))
        tg = to_port(ref_tg)
        try:
            res = build_memgraph(tg, BuildConfig(capacity=3, host_capacity=2,
                                                 rng_seed=seed, **UNITS))
        except MemgraphOOM:
            continue
        mg = res.memgraph
        mem_edges = [(u, v) for u in mg.vertices for v, k in
                     mg.succs[u].items() if k == DepKind.MEM]
        for u, v in mem_edges:
            mg.remove_dep(u, v)
            cert = certify(mg, host_capacity=2)
            for h in cert.hazards:
                if not h.confirmable:
                    continue
                try:
                    confirm_hazard(tg, res, h, seed=seed)
                except AssertionError:
                    continue      # statically real but value-coincident
                n_confirmed += 1
                break
            mg.add_dep(u, v, DepKind.MEM)
            if n_confirmed >= 3:
                return
    assert n_confirmed >= 3, "edge-deletion sweep never produced a " \
        "confirmable hazard"


def test_compiled_seams_exercised_on_unbounded_host_plans():
    """fig3's INPUT streams race on the h2d engine: the compiled backend
    interprets those seams, runs the rest straight-line, and matches the
    oracle under every policy."""
    ref_tg = fig3_taskgraph()
    tg = to_port(ref_tg)
    res = build_memgraph(tg, BuildConfig(capacity=3, rng_seed=0, **UNITS))
    inputs = graph_inputs(ref_tg, 0)
    ref = eval_taskgraph(tg, inputs, **CPU)
    for policy in POLICY_NAMES:
        rr = TurnipRuntime(tg, res, mode="nondet", policy=policy, seed=0,
                           exec_backend="compiled", **CPU).run(inputs)
        _assert_equal(rr.outputs, ref, f"compiled-seams/{policy}")
        assert rr.n_interpreted > 0, "no seam region was interpreted"
        assert rr.n_compiled > 0, "nothing ran straight-line"


# ------------------------------------------------------ liveness replays
def _build(ref_tg, **kw):
    kw.setdefault("capacity", 3)
    tg = to_port(ref_tg)
    return tg, build_memgraph(tg, BuildConfig(**kw, **UNITS))


def test_forged_revocation_cycle_flagged_and_stalls():
    cfg = PoolConfig(capacity=6, leases=(
        LeaseSpec("a", min_bytes=1, discipline="reserving",
                  drains_via=("b",)),
        LeaseSpec("b", min_bytes=1, discipline="reserving",
                  drains_via=("a",))))
    cert = certify_progress(MemGraph(), cfg)
    assert not cert.ok
    haz = [h for h in cert.hazards if h.kind == REVOCATION_CYCLE]
    assert haz and haz[0].confirmable and haz[0].witness_kind == "stall"
    how = confirm_hazard(None, None, haz[0], cert=cert)
    assert "stalled" in how and "drains" in how


def test_lease_floors_infeasible_under_revocation_stalls():
    tg, res = _build(fig3_taskgraph(), host_capacity=2)
    mg = res.memgraph
    base = certify_progress(mg, default_pool_config(2))
    assert base.ok
    worst = base.worst_lease_units
    assert worst >= 1
    cfg = PoolConfig(capacity=worst + 1, leases=(
        LeaseSpec("plan", min_bytes=worst - 1),
        LeaseSpec("serve", discipline="reserving")), plan_lease="plan")
    cert = certify_progress(mg, cfg)
    assert not cert.ok
    haz = [h for h in cert.hazards if h.kind == LEASE_FLOOR_STALL]
    assert haz, cert.summary()
    h = haz[0]
    assert h.witness_kind == "stall" and h.lease == "plan"
    assert h.expect_units == worst and h.capacity == worst - 1
    assert "stalled" in confirm_hazard(tg, res, h, cert=cert)


def test_disk_credit_cycle_flagged_and_stalls():
    tg, res = _build(fig3_taskgraph(), host_capacity=1)
    mg = res.memgraph
    _, disk = recover_residencies(mg)
    assert len(disk) >= 2
    forged = None
    for r in disk:
        for s in disk:
            if r is s or mg.happens_before(s.admit, r.admit):
                continue
            if r.release is not None:
                if mg.happens_before(r.release, s.admit):
                    continue
                if not mg.happens_before(s.admit, r.release):
                    mg.add_dep(s.admit, r.release, DepKind.MEM)
            if not mg.happens_before(r.admit, s.admit):
                mg.add_dep(r.admit, s.admit, DepKind.MEM)
            forged = (r, s)
            break
        if forged:
            break
    assert forged is not None
    r, s = forged
    cert = certify_progress(mg, default_pool_config(1),
                            disk_capacity=r.units + s.units - 1)
    assert not cert.ok
    haz = [h for h in cert.hazards if h.kind == DISK_CREDIT_STALL]
    assert haz, cert.summary()
    assert haz[0].witness_kind == "stall" and haz[0].tier == "disk"
    assert "stalled" in confirm_hazard(tg, res, haz[0], cert=cert)


def test_atomic_admission_batch_past_guarantee_stalls():
    cfg = PoolConfig(capacity=8, leases=(
        LeaseSpec("kv", min_bytes=2, discipline="reserving",
                  atomic_bytes=5),
        LeaseSpec("other", min_bytes=1)))
    cert = certify_progress(MemGraph(), cfg)
    assert not cert.ok
    haz = [h for h in cert.hazards if h.kind == ATOMIC_ADMISSION_STALL]
    assert haz, cert.summary()
    h = haz[0]
    assert h.lease == "kv" and h.expect_units == 5 and h.capacity == 2
    assert "stalled" in confirm_hazard(None, None, h, cert=cert)


def test_replay_stall_rejects_unknown_kinds():
    h = PlanHazard("lease-floors-infeasible", (), "structural")
    with pytest.raises(AssertionError, match="no stall replay"):
        replay_stall(h, None)


def test_certified_clean_safety_witness_still_replays():
    tg, res = _build(fig3_taskgraph(), host_capacity=1)
    base = certify(res.memgraph)
    assert base.ok and base.worst_host_units > 0
    cert = certify(res.memgraph, host_capacity=base.worst_host_units - 1)
    hosts = [h for h in cert.hazards if h.kind == "host-budget"]
    assert hosts
    assert "occupancy" in confirm_hazard(tg, res, hosts[0])


@pytest.mark.parametrize("exec_backend", ["interpreted", "compiled"])
def test_liveness_certified_plans_complete_under_all_policies(exec_backend):
    """A plan built with ``certify_liveness`` runs to the oracle's bytes
    under every policy, and its compiled lowering may fuse disk runs and
    the H2D/D2H pair (both gated on the certificate)."""
    n_ran = 0
    for seed in range(20):
        ref_tg = random_taskgraph(pyrandom.Random(1000 + seed))
        try:
            tg, res = _build(ref_tg, host_capacity=2, disk_capacity=50,
                             certify_liveness=True)
        except MemgraphOOM:
            continue
        assert res.liveness_certificate is not None
        assert res.liveness_certificate.ok
        inputs = graph_inputs(ref_tg, seed)
        ref = eval_taskgraph(tg, inputs, **CPU)
        for policy in POLICY_NAMES:
            rr = TurnipRuntime(tg, res, policy=policy, seed=seed,
                               exec_backend=exec_backend, **CPU).run(inputs)
            _assert_equal(rr.outputs, ref, f"{exec_backend}/{policy}")
        n_ran += 1
        if n_ran >= 4:
            return
    assert n_ran >= 1
