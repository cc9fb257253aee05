"""Twins of ``tests/test_router.py`` for the port's fleet layer
(``repro_torch/serve/router.py``, the engine's fleet seams and
``repro_torch/launch/mesh.py``), and the wire format across the packages.

The port's :class:`Router` runs its replicas on the CPU (``device="cpu"``)
with the reference's parameters (``params_from_reference``, reduced
olmo-1b, float32, greedy), and every fleet's tokens must equal the
reference's :func:`repro.serve.naive_generate` exactly: under every
placement policy and kill instant, with a paused replica, through a warm
ticket, and with a live rebalance. A killed fleet leaks no thread, and each
surviving replica's host pool stays within capacity and drains to zero.

Every fault is armed before the first submit, heartbeats time out after
60 s (a replica's first forward in a fresh thread is slow on a loaded
machine, and a healthy replica must never be drained for it), and every
wait has a timeout.

Across the packages: a ticket encoded by either codec decodes in the other
to the same header and the same bytes, in float32 and in bfloat16 leaves,
and the two encoders write the same blob; the port's
``PagedKVCache.leaf_spec()`` equals the reference's for the same model and
configuration; and a warm ticket exported by the port, carried through the
reference's codec, resumes token-exact on another port replica.
"""
import dataclasses
import os
import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.serve import MigrationTicket as RefTicket
from repro.serve import PagedKVCache as RefPagedKVCache
from repro.serve import decode_ticket as ref_decode_ticket
from repro.serve import encode_ticket as ref_encode_ticket
from repro.serve import naive_generate as ref_naive_generate
from repro_torch.configs import get_arch, reduced
from repro_torch.core import HostPool, lockcheck
from repro_torch.core.bridge import numpy_bytes, params_from_reference
from repro_torch.launch.mesh import FleetTopology, make_fleet_topology
from repro_torch.models import build_model
from repro_torch.serve import (MigrationRefused, MigrationTicket,
                               PLACEMENT_POLICY_NAMES, Engine, PagedKVCache,
                               ReplicaKilled, Router, ServeConfig,
                               decode_ticket, encode_ticket, get_placement)

torch.set_num_threads(1)

MAX_LEN = 128
SEED = 7
WAIT_S = 300.0
# thread-name prefixes the fleet owns: any of them alive after close() is
# a leak
FLEET_THREADS = ("router-", "nic", "serve-dma-")


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


@pytest.fixture(scope="module")
def lm():
    """(reference model, its params, port model, port params), float32."""
    rm = ref_build_model(ref_reduced(ref_get_arch("olmo-1b")))
    rp = rm.init(jax.random.PRNGKey(0))
    pm = build_model(reduced(get_arch("olmo-1b")), device="cpu")
    pp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    return rm, rp, pm, pp


def fleet_cfg(**kw):
    base = dict(max_len=MAX_LEN, batch_buckets=(1, 2), block_size=16,
                offload=True, hot_window=16, preempt_every=2,
                h2d_bw=4e9, d2h_bw=4e9, seed=SEED)
    base.update(kw)
    return ServeConfig(**base)


def make_prompts(vocab, n, seed=1, lo=17, hi=40):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, size=int(k))))
            for k in rng.integers(lo, hi, size=n)]


_ORACLE: dict = {}


def oracle(lm, prompts, rids, *, max_new):
    """The reference's unbatched greedy tokens of each (prompt, rid)."""
    rm, rp, _, _ = lm
    out = []
    for p, r in zip(prompts, rids):
        key = (tuple(p), r, max_new)
        if key not in _ORACLE:
            _ORACLE[key] = ref_naive_generate(rm, rp, p, max_new=max_new,
                                              max_len=MAX_LEN, rid=r,
                                              seed=SEED)
        out.append(_ORACLE[key])
    return out


def assert_no_fleet_threads():
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        leaked = [t.name for t in threading.enumerate() if t.is_alive()
                  and any(t.name.startswith(p) for p in FLEET_THREADS)]
        if not leaked:
            return
        time.sleep(0.05)
    assert not leaked, f"fleet threads leaked past close(): {leaked}"


def run_chaos(lm, *, placement, kill_step, prompt_seed=1, n_replicas=3,
              n_prompts=9, max_new=12, kill_index=0):
    """One chaos case: N replicas, one hard-killed once its decode-step
    counter reaches ``kill_step``. Returns the router summary."""
    _, _, pm, pp = lm
    topo = FleetTopology(n_replicas=n_replicas, heartbeat_timeout_s=60.0,
                         host_bytes_per_replica=64 << 20)
    prompts = make_prompts(pm.cfg.vocab_size, n_prompts, seed=prompt_seed)
    with Router(pm, pp, fleet_cfg(), topology=topo,
                placement=placement) as router:
        # armed BEFORE any submit: the victim cannot run a decode step
        # first, so the kill fires at exactly kill_step on every schedule
        router.replicas[kill_index].engine.fault_after_steps = kill_step
        rids = [router.submit(p, max_new=max_new) for p in prompts]
        router.wait(rids, timeout=WAIT_S)
        outs = [router.result(r) for r in rids]
        summ = router.summary()
        assert summ["replicas_killed"] == 1
        assert not router.replicas[kill_index].alive
        assert summ["drain_time"] > 0
        for rep in router.replicas:
            if rep.pool is not None and not rep.closed:
                assert rep.pool.peak_bytes <= rep.pool.capacity
                # drain is eventual: an in-flight mirror of a finished
                # request releases its charge when its copy lands
                deadline = time.monotonic() + 30
                while (not rep.pool.drained
                       and time.monotonic() < deadline):
                    time.sleep(0.005)
                assert rep.pool.drained, rep.pool.snapshot()
    assert outs == oracle(lm, prompts, rids, max_new=max_new)
    assert summ["completed"] == n_prompts
    assert_no_fleet_threads()
    return summ


# ------------------------------------------------------------ chaos sweep
@pytest.mark.parametrize("placement,kill_step",
                         [("least-loaded", 3),
                          ("join-shortest-kv", 6),
                          ("random", 9)])
def test_replica_kill_mid_decode_token_exact(lm, placement, kill_step):
    """1 of 3 replicas hard-killed mid-decode at a seeded step, under every
    placement policy: every request completes with the reference oracle's
    tokens, no thread leaks, surviving pools stay bounded and drain."""
    summ = run_chaos(lm, placement=placement, kill_step=kill_step)
    assert summ["migrations"] + summ["reprefills"] > 0


def test_no_fault_fleet_matches_oracle(lm):
    """The same burst with no kill: placement and batching across 3
    replicas, token-exact; nothing drained, nothing migrated; every replica
    that hosted work has TTFT samples."""
    _, _, pm, pp = lm
    topo = make_fleet_topology(3, heartbeat_timeout_s=60.0)
    prompts = make_prompts(pm.cfg.vocab_size, 7, seed=2)
    with Router(pm, pp, fleet_cfg(), topology=topo,
                placement="least-loaded") as router:
        rids = [router.submit(p, max_new=10) for p in prompts]
        router.wait(rids, timeout=WAIT_S)
        outs = [router.result(r) for r in rids]
        summ = router.summary()
    assert outs == oracle(lm, prompts, rids, max_new=10)
    assert summ["replicas_killed"] == 0
    assert summ["migrations"] == 0 and summ["reprefills"] == 0
    assert summ["ttft_p99"] and all(v > 0 for v in summ["ttft_p99"].values())
    assert_no_fleet_threads()


def test_paused_replica_detected_and_drained(lm):
    """A replica that stops beating without crashing (``pause()``) is
    drained like a crash: detected by its missed heartbeat (backdated, so
    no real timeout is slept), killed, its requests resumed token-exact."""
    _, _, pm, pp = lm
    topo = FleetTopology(n_replicas=2, heartbeat_timeout_s=60.0)
    prompts = make_prompts(pm.cfg.vocab_size, 6, seed=3)
    with Router(pm, pp, fleet_cfg(), topology=topo,
                placement="least-loaded") as router:
        rids = [router.submit(p, max_new=10) for p in prompts]
        victim = router.replicas[0]
        # freeze the victim while it provably holds live work
        deadline = time.monotonic() + 120
        busy = False
        while not busy and time.monotonic() < deadline:
            victim.engine.pause()
            with victim.engine._lock:
                busy = bool(victim.engine._live)
            if not busy:
                victim.engine.resume()
                time.sleep(0.005)
        assert busy, "victim never picked up work"
        router.heartbeat.beat(victim.name,
                              now=time.monotonic() - 2 * 60.0 - 1)
        router.wait(rids, timeout=WAIT_S)
        outs = [router.result(r) for r in rids]
        summ = router.summary()
        assert not victim.alive and victim.closed
        assert victim.engine.kv is None          # its device cache is freed
    assert outs == oracle(lm, prompts, rids, max_new=10)
    assert summ["replicas_killed"] == 1
    assert_no_fleet_threads()


# --------------------------------------------------- warm migration, direct
def _capture_warm_ticket(engine, deadline_s=120.0):
    """Run ``engine`` on a thread and pause it the moment a swapped
    request's full block set is quiescent, then detach that request as a
    warm ticket."""
    err = []

    def _run():
        try:
            engine.run()
        except ReplicaKilled:
            pass
        except BaseException as e:   # noqa: BLE001
            err.append(e)

    t = threading.Thread(target=_run)
    t.start()
    ticket = None
    deadline = time.monotonic() + deadline_s
    try:
        while ticket is None and time.monotonic() < deadline:
            engine.pause()
            ticket = engine.export_one_swapped()
            if ticket is None:
                engine.resume()
                time.sleep(0.002)
    finally:
        engine.resume()
    assert not err, err
    assert ticket is not None, "no swapped request became exportable"
    return ticket, t


def _outs(engines, rids):
    got = {}
    for eng in engines:
        for rid, req in eng.reqs.items():
            if rid in rids:
                got[rid] = list(req.out)
    return [got[r] for r in rids]


def test_warm_ticket_ships_bit_exact_and_resumes(lm):
    """A swapped request captured off a busy single-slot engine,
    serialised, decoded and imported on a second replica: the decoded
    payload is byte-identical to the exported one, and the migrated request
    (and the ones that stayed) complete token-exact."""
    _, _, pm, pp = lm
    cfg = fleet_cfg(batch_buckets=(1,))
    a = Engine(pm, pp, cfg, name="src")
    b = Engine(pm, pp, cfg, name="dst")
    prompts = make_prompts(pm.cfg.vocab_size, 3, seed=4)
    rids = [a.submit(p, max_new=10, rid=100 + i)
            for i, p in enumerate(prompts)]
    ticket, worker = _capture_warm_ticket(a)
    assert ticket.warm and ticket.rid in rids
    blob = encode_ticket(ticket)
    wire = decode_ticket(blob)
    assert wire.rid == ticket.rid and wire.out == ticket.out
    assert len(wire.blocks) == len(ticket.blocks)
    for got, want in zip(wire.blocks, ticket.blocks):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k])
    b.import_migration(wire)
    assert b.stats.migrations_in == 1 and a.stats.migrations_out == 1
    for blk, want in enumerate(ticket.blocks):
        landed = b.host.peek_offload((ticket.rid, blk))
        assert all(torch.equal(landed[k], want[k]) for k in want)
    worker.join(timeout=WAIT_S)
    assert not worker.is_alive()
    b.run()
    assert _outs((a, b), rids) == oracle(lm, prompts, rids, max_new=10)
    a.close()
    b.close()


def test_import_refusal_is_all_or_nothing(lm):
    """A ticket the destination cannot validate or fund leaves nothing
    behind: no request record, no host bytes, no lease charge."""
    _, _, pm, pp = lm
    cfg = fleet_cfg(batch_buckets=(1,))
    a = Engine(pm, pp, cfg, name="src")
    prompts = make_prompts(pm.cfg.vocab_size, 3, seed=5)
    [a.submit(p, max_new=10, rid=200 + i) for i, p in enumerate(prompts)]
    ticket, worker = _capture_warm_ticket(a)
    a.hard_kill()
    worker.join(timeout=WAIT_S)
    assert not worker.is_alive()

    # wrong block geometry → refused before any state lands
    b = Engine(pm, pp, fleet_cfg(block_size=32), name="dst-geom")
    with pytest.raises(MigrationRefused, match="block_size"):
        b.import_migration(ticket)
    assert ticket.rid not in b.reqs
    b.close()

    # a leaf of the wrong dtype → refused by the leaf spec
    bad = dataclasses.replace(ticket, blocks=[
        {k: v.to(torch.float16) for k, v in blk.items()}
        for blk in ticket.blocks])
    e = Engine(pm, pp, fleet_cfg(), name="dst-spec")
    with pytest.raises(MigrationRefused, match="float16"):
        e.import_migration(bad)
    assert ticket.rid not in e.reqs
    assert e.host.peek_offload((ticket.rid, 0)) is None
    e.close()

    # a pool too small to fund the set → every charge rolled back
    pool = HostPool(1024)
    c = Engine(pm, pp, fleet_cfg(), pool=pool, name="dst-poor")
    with pytest.raises(MigrationRefused, match="cannot reserve"):
        c.import_migration(ticket)
    assert ticket.rid not in c.reqs
    assert pool.used_bytes == 0 and pool.drained
    assert c.host.peek_offload((ticket.rid, 0)) is None
    c.close()

    # cold tickets are never importable: the contract is resubmission
    cold = MigrationTicket(rid=1, prompt=[1, 2], out=[3], max_new=4,
                           pos=2, last=3, block_size=16)
    d = Engine(pm, pp, fleet_cfg(), name="dst-cold")
    with pytest.raises(MigrationRefused, match="cold"):
        d.import_migration(cold)
    d.close()
    a.close()


def test_rebalance_moves_a_swapped_request(lm):
    """Live migration with no fault: with one replica saturated,
    ``rebalance_once`` ships a swapped request over the NIC and the burst
    still completes token-exact."""
    _, _, pm, pp = lm
    topo = FleetTopology(n_replicas=2, heartbeat_timeout_s=60.0)
    prompts = make_prompts(pm.cfg.vocab_size, 6, seed=6)
    with Router(pm, pp, fleet_cfg(batch_buckets=(1,)), topology=topo,
                placement="least-loaded") as router:
        rids = [router.submit(p, max_new=12) for p in prompts]
        moved = False
        deadline = time.monotonic() + 120
        while not moved and time.monotonic() < deadline:
            moved = router.rebalance_once()
            if not moved:
                time.sleep(0.002)
            if all(router.done(r) for r in rids):
                break
        router.wait(rids, timeout=WAIT_S)
        outs = [router.result(r) for r in rids]
        summ = router.summary()
    assert outs == oracle(lm, prompts, rids, max_new=12)
    if moved:     # near-certain under (1,)-bucket saturation, but
        #           completion can win the race; exactness never waits
        assert summ["migrations"] + summ["reprefills"] >= 1
    assert_no_fleet_threads()


# ------------------------------------------------------------- unit pieces
def test_codec_rejects_corruption():
    t = MigrationTicket(
        rid=3, prompt=[1, 2, 3], out=[4], max_new=8, pos=4, last=4,
        block_size=4, blocks=[{"k": torch.arange(8, dtype=torch.float32)
                               .reshape(2, 4)}])
    blob = encode_ticket(t)
    assert decode_ticket(blob).blocks[0]["k"].dtype == torch.float32
    with pytest.raises(ValueError, match="magic"):
        decode_ticket(b"XXXX" + blob[4:])
    with pytest.raises(ValueError, match="torn"):
        decode_ticket(blob[:-3])
    with pytest.raises(ValueError, match="trailing"):
        decode_ticket(blob + b"\x00")


def test_placement_policies():
    class _Eng:
        def __init__(self, n, kv):
            self._n, self._kv = n, kv

        def load(self):
            return self._n, self._kv

    class _Rep:
        def __init__(self, i, n, kv):
            self.index, self.engine = i, _Eng(n, kv)

    reps = [_Rep(0, 3, 10), _Rep(1, 1, 99), _Rep(2, 1, 5)]
    assert get_placement("least-loaded").pick(reps).index == 1  # tie → index
    assert get_placement("join-shortest-kv").pick(reps).index == 2
    rng_picks = {get_placement("random", seed=s).pick(reps).index
                 for s in range(16)}
    assert len(rng_picks) > 1                   # seeded but not degenerate
    assert set(PLACEMENT_POLICY_NAMES) == {"least-loaded",
                                           "join-shortest-kv", "random"}
    with pytest.raises(ValueError, match="unknown placement"):
        get_placement("nope")


def test_fleet_topology_validation():
    topo = make_fleet_topology(3, name_prefix="r")
    assert topo.replica_names == ("r-0", "r-1", "r-2")
    assert (topo.nic_bw, topo.nic_latency) == (3.1e9, 50e-6)
    with pytest.raises(ValueError):
        FleetTopology(n_replicas=0)


# ------------------------------------------------------ across the packages
def _tickets(dtype: str, warm: bool = True):
    """The same ticket in both packages: (port ticket, reference ticket)."""
    rng = np.random.default_rng(11)
    blocks_np = [{"k": rng.normal(size=(2, 4, 3, 5)).astype(np.float32),
                  "v": rng.normal(size=(2, 4, 3, 5)).astype(np.float32)}
                 for _ in range(3)]
    if dtype == "bfloat16":
        blocks_np = [{k: a.astype(ml_dtypes.bfloat16) for k, a in b.items()}
                     for b in blocks_np]

    def port_leaf(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    kw = dict(rid=5, prompt=[9, 8, 7], out=[1, 2], max_new=6, pos=10, last=2,
              block_size=4, t_submit=12.5, t_first=13.25)
    port = MigrationTicket(**kw, blocks=[{k: port_leaf(a)
                                          for k, a in b.items()}
                                         for b in blocks_np]
                           if warm else None)
    ref = RefTicket(**kw, blocks=blocks_np if warm else None)
    return port, ref


def _same_ticket(port: MigrationTicket, ref) -> None:
    for f in ("rid", "prompt", "out", "max_new", "pos", "last",
              "block_size", "t_submit", "t_first", "warm"):
        assert getattr(port, f) == getattr(ref, f), f
    if not port.warm:
        return
    assert len(port.blocks) == len(ref.blocks)
    for pb, rb in zip(port.blocks, ref.blocks):
        assert set(pb) == set(rb)
        for k in rb:
            name, raw = numpy_bytes(pb[k])
            assert name == str(rb[k].dtype)
            assert tuple(pb[k].shape) == rb[k].shape
            assert raw.tobytes() == np.ascontiguousarray(rb[k]).tobytes()


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_decodes_port_tickets(dtype, warm):
    port, ref = _tickets(dtype, warm)
    blob = encode_ticket(port)
    _same_ticket(port, ref_decode_ticket(blob))
    assert blob == ref_encode_ticket(ref)       # byte for byte one format


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_decodes_reference_tickets(dtype, warm):
    port, ref = _tickets(dtype, warm)
    got = decode_ticket(ref_encode_ticket(ref))
    _same_ticket(got, ref)
    if warm:
        for gb, pb in zip(got.blocks, port.blocks):
            for k in pb:
                assert gb[k].dtype == pb[k].dtype
                assert torch.equal(gb[k], pb[k])


@pytest.mark.parametrize("dtype,kv", [("float32", "bf16"),
                                      ("bfloat16", "bf16"),
                                      ("bfloat16", "int8")])
def test_leaf_spec_matches_reference(dtype, kv):
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_arch("olmo-1b")),
                                  dtype=dtype)
    cfg = dataclasses.replace(reduced(get_arch("olmo-1b")), dtype=dtype)
    rm = ref_build_model(ref_cfg, kv_cache_dtype=kv)
    pm = build_model(cfg, device="cpu", kv_cache_dtype=kv)
    want = RefPagedKVCache(rm, 2, 64, block_size=16).leaf_spec()
    got = PagedKVCache(pm, 2, 64, block_size=16).leaf_spec()
    assert got == want
    assert all(isinstance(d, str) and not d.startswith("torch.")
               for _, d in got.values())


def test_port_ticket_through_reference_codec_resumes(lm):
    """A warm ticket exported by a port replica, decoded and re-encoded by
    the reference's codec, imports on another port replica and finishes
    token-exact."""
    _, _, pm, pp = lm
    cfg = fleet_cfg(batch_buckets=(1,))
    a = Engine(pm, pp, cfg, name="src")
    b = Engine(pm, pp, cfg, name="dst")
    prompts = make_prompts(pm.cfg.vocab_size, 3, seed=8)
    rids = [a.submit(p, max_new=10, rid=300 + i)
            for i, p in enumerate(prompts)]
    ticket, worker = _capture_warm_ticket(a)
    blob = ref_encode_ticket(ref_decode_ticket(encode_ticket(ticket)))
    assert blob == encode_ticket(ticket)
    b.import_migration(decode_ticket(blob))
    worker.join(timeout=WAIT_S)
    assert not worker.is_alive()
    b.run()
    assert _outs((a, b), rids) == oracle(lm, prompts, rids, max_new=10)
    a.close()
    b.close()


# --------------------------------------------------------------- slow lane
@pytest.mark.slow
def test_fuzz_chaos_kill_instants(lm):
    """Hypothesis lane (``-m slow``, scaled by ``FUZZ_EXAMPLES``): random
    placement policy × kill instant × burst shape, every run token-exact
    with no leaked threads."""
    pytest.importorskip("hypothesis")
    from hypothesis import HealthCheck, given, settings, strategies as st

    max_examples = max(2, int(os.environ.get("FUZZ_EXAMPLES", "25")) // 10)

    @settings(max_examples=max_examples, deadline=None,
              suppress_health_check=[HealthCheck.too_slow,
                                     HealthCheck.function_scoped_fixture])
    # kill_step stays below max_new: a victim holding a single request
    # completes it in exactly max_new decode steps
    @given(placement=st.sampled_from(PLACEMENT_POLICY_NAMES),
           kill_step=st.integers(1, 9),
           prompt_seed=st.integers(0, 2**16),
           kill_index=st.integers(0, 2))
    def inner(placement, kill_step, prompt_seed, kill_index):
        run_chaos(lm, placement=placement, kill_step=kill_step,
                  prompt_seed=prompt_seed, n_prompts=7, max_new=10,
                  kill_index=kill_index)

    inner()
