"""The meshed training step of every family against the un-meshed one, in
four ``gloo`` processes on a 2 x 2 ``('data', 'model')`` mesh on the CPU.

One ``torch.multiprocessing.spawn`` runs every case. Each rank draws the
same parameters and batch from one seed, computes ``loss`` and its
gradients un-meshed, then again with the parameters sharded by the rules
(``sharding.rules.param_spec``), the batch by ``batch_spec`` and the
mesh active (``use_mesh``): ``constrain`` redistributes the activations
and the kernels run on their local shards (``sharding.local``). The rule,
float32: the meshed loss within 1e-5 of the un-meshed one relative to
it, and every gradient leaf within ``1e-6 + 1e-4 * max|un-meshed leaf|``
of it, element by element (the mesh only reorders sums). The un-meshed
port equals the reference (``tests/test_torch_train.py``,
``test_torch_encdec.py``, ``test_torch_vision.py``).

The same spawn then runs the reduced MoE model (4 experts, top-2) on
three meshes, (2, 2), (4, 1) and (1, 4), with a capacity low enough that
an expert's queue overflows across a rank boundary and dropless. Each
rank routes only its own tokens and places its pairs in the experts'
queues by the counts of the ranks before it; beside the rule above, the
kept-pair mask (and each pair's expert) of every rank's window, put
together, must equal the un-meshed one exactly, and with a capacity,
where ranks split the tokens ((2, 2), (4, 1)), some pair of a later rank
must be dropped that its own rank's tokens alone would have kept. Once
more on (4, 1) with 2 rows, which do not divide 'data': the ranks share
the batch by windows of its flattened tokens.

Then, by the same rule: the dense model's loss on the 3-D mesh (2, 1, 2)
(``'pod'``, ``'data'``, ``'model'``), where the head's product and the
vocabulary-parallel loss run on local shards; ``embed_rows`` alone on
(2, 2), vocabulary-parallel with the table's gradient, and, for a table
without one and fewer ids than a rank's rows (a decode step), the lookup
that gathers the ids instead of the table (its output equal exactly);
one Mamba block (``ssm.ssd_block``) forward and backward on (1, 4) and
(2, 2), its in-projection split by heads over ``'model'``; the one-token
``decode_attention`` on (1, 4) over caches that the cache rules shard over
``'model'`` by heads, by head features and by the sequence; one
``decode_step`` of the dense, rwkv and zamba models on (2, 2) from a
random cache (the lookup gathering the ids, the attention and the
recurrences from a state on local shards), its logits and every cache
leaf it writes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import socket
import traceback

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
B, S = 4, 16
MOE_MESHES = ((2, 2), (4, 1), (1, 4))
# C = int(0.75 * 64 tokens * 2 / 4) = 24 pairs an expert, of ~32
MOE_CAPACITY = {"capacity": 0.75, "dropless": None}
# 2 rows do not divide 'data' = 4: the four ranks share the batch by
# windows of 8 tokens, and their outputs are partial sums over 'data'
MOE_SHARED_ROWS = 2


def _cases() -> dict:
    llama = reduced(get_arch("llama-7b"))
    return {
        "dense": llama,
        # one KV head a query group that spans both 'model' ranks: K and V
        # replicated over 'model', each rank slicing its head
        "dense-kv1": dataclasses.replace(llama, n_kv_heads=1),
        "moe": reduced(get_arch("granite-moe-1b-a400m")),
        "zamba": reduced(get_arch("zamba2-7b")),
        "rwkv": reduced(get_arch("rwkv6-7b")),
        "encdec": reduced(get_arch("seamless-m4t-large-v2")),
        "vit": reduced(get_arch("internvl2-26b")),
    }


def _batch(cfg, rows: int = B) -> dict:
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (rows, S + 1))
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])}
    if cfg.family == "encdec":
        batch["encoder_embeds"] = torch.from_numpy(
            rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32))
    if cfg.frontend == "vit":
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    return batch


def _moe_cases() -> dict:
    cases = {f"moe-{kind}-{d}x{m}": ((d, m), cf, B)
             for (d, m) in MOE_MESHES for kind, cf in MOE_CAPACITY.items()}
    cases["moe-capacity-4x1-shared-rows"] = ((4, 1), MOE_CAPACITY["capacity"],
                                             MOE_SHARED_ROWS)
    return cases


def _compare(cfg, mesh, rows: int = B, **model_kw) -> dict:
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import (batch_spec, param_spec,
                                            shard_tree, use_mesh)
    from repro_torch.train.step import value_and_grad
    from repro_torch.train.tree import flatten

    model = build_model(cfg, device="cpu", **model_kw)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg, rows)
    loss0, g0 = value_and_grad(model.loss, params, batch)
    dparams = shard_tree(params, param_spec(params, mesh), mesh)
    dbatch = shard_tree(batch, batch_spec(batch, mesh), mesh)
    with use_mesh(mesh):
        loss1, g1 = value_and_grad(model.loss, dparams, dbatch)
    loss1 = float(loss1.full_tensor())
    worst, where = 0.0, ""
    for (path, a), (_, b) in zip(flatten(g0), flatten(g1)):
        b = b.full_tensor()
        lim = GRAD_ATOL + GRAD_RTOL * a.abs().max().item()
        ratio = ((a - b).abs().max().item()) / lim
        if ratio > worst:
            worst, where = ratio, path
    return {"loss": float(loss0), "loss_meshed": loss1,
            "grad_ratio": worst, "grad_worst_leaf": where,
            "leaves": len(flatten(g0))}


def _queue_places(expert: np.ndarray) -> np.ndarray:
    """Each pair's place in its expert's queue among the pairs of
    ``expert`` [T, k] alone, in flattened (t, k) order."""
    flat = expert.reshape(-1)
    place = np.empty_like(flat)
    for e in np.unique(flat):
        at = np.flatnonzero(flat == e)
        place[at] = np.arange(len(at))
    return place.reshape(expert.shape)


def _compare_moe(cfg, mesh, capacity_factor, rows: int = B) -> dict:
    """:func:`_compare` of the MoE model, with every ``_moe_dispatch`` call
    recorded: the un-meshed calls whole, the meshed ones a window a rank,
    put together by each window's start in the batch's token order."""
    import torch.distributed as dist
    from repro_torch.models import layers

    calls = {"whole": [], "window": []}
    dispatch = layers._moe_dispatch

    def recorded(probs, top_k, n_experts, cf, n_tokens, shard):
        out = dispatch(probs, top_k, n_experts, cf, n_tokens, shard)
        keep = out[6]
        calls["whole" if shard is None else "window"].append(
            (0 if shard is None else shard.start, out[1].tolist(),
             None if keep is None else keep.tolist()))
        return out
    layers._moe_dispatch = recorded
    try:
        r = _compare(cfg, mesh, rows, moe_capacity_factor=capacity_factor)
    finally:
        layers._moe_dispatch = dispatch
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, calls["window"])
    T, k = rows * S, cfg.top_k
    C = (None if capacity_factor is None else
         max(1, int(capacity_factor * T * k / cfg.n_experts)))
    same, across = len(calls["whole"]) > 0, 0
    for layer, (_, expert, keep) in enumerate(calls["whole"]):
        got_e = np.full((T, k), -1)
        got_k = np.zeros((T, k), dtype=bool)
        for rank_calls in ranks:
            start, e_w, k_w = rank_calls[layer]
            e_w = np.asarray(e_w).reshape(-1, k)
            got_e[start:start + len(e_w)] = e_w
            if k_w is None:
                same &= keep is None
                continue
            k_w = np.asarray(k_w, dtype=bool).reshape(-1, k)
            got_k[start:start + len(k_w)] = k_w
            if start > 0:       # dropped here, kept by its own rank alone
                across += int((~k_w & (_queue_places(e_w) < C)).sum())
        same &= bool((got_e == np.asarray(expert)).all())
        if keep is not None:
            same &= bool((got_k == np.asarray(keep, dtype=bool)).all())
    windows = {rank_calls[0][0] for rank_calls in ranks if rank_calls}
    return dict(r, keep_equal=same, dropped_across=across, capacity=C,
                layers=len(calls["whole"]), windows=len(windows))


def _max_ratio(pairs) -> tuple[float, str]:
    """The worst |a - b| / (GRAD_ATOL + GRAD_RTOL max|a|) over named
    (un-meshed, meshed) tensor pairs, and where it is."""
    worst, where = 0.0, ""
    for name, a, b in pairs:
        b = b.full_tensor() if hasattr(b, "full_tensor") else b
        lim = GRAD_ATOL + GRAD_RTOL * a.abs().max().item()
        ratio = (a - b).abs().max().item() / lim
        if ratio > worst:
            worst, where = ratio, name
    return worst, where


@contextlib.contextmanager
def _counted(module, name: str):
    """Count the calls of ``module.name`` inside the block: ``[n]``."""
    fn, calls = getattr(module, name), [0]

    def counted(*a, **k):
        calls[0] += 1
        return fn(*a, **k)
    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def _compare_embed(mesh) -> dict:
    """``embed_rows`` on the reduced llama's table: with a gradient over
    B x S ids (the table gathered over 'data'), and without one over one
    id a row (the ids gathered, an all-to-all over 'data')."""
    from repro_torch.sharding import local
    from repro_torch.sharding.rules import (embed_rows, param_spec,
                                            shard_tree, use_mesh)
    cfg = reduced(get_arch("llama-7b"))
    g = torch.Generator().manual_seed(1)
    table = torch.randn(cfg.padded_vocab, cfg.d_model, generator=g)
    w = torch.randn(B, S, cfg.d_model, generator=g)
    ids = _batch(cfg)["tokens"]
    spec = param_spec({"embed": table}, mesh)
    t0 = table.clone().requires_grad_(True)
    y0 = embed_rows(t0, ids)
    (g0,) = torch.autograd.grad((y0 * w).sum(), [t0])
    dt = shard_tree({"embed": table}, spec, mesh)["embed"]
    dt.requires_grad_(True)
    dids = shard_tree({"ids": ids}, {"ids": ("data", None)}, mesh)["ids"]
    step = ids[:, :1]
    dstep = shard_tree({"ids": step}, {"ids": ("data", None)}, mesh)["ids"]
    frozen = shard_tree({"embed": table}, spec, mesh)["embed"]
    with use_mesh(mesh), _counted(local, "_embed_columns") as calls:
        y1 = embed_rows(dt, dids)
        (g1,) = torch.autograd.grad((y1 * w).sum(), [dt])
        gathered = calls[0]
        decode = embed_rows(frozen, dstep)
    ratio, where = _max_ratio([("out", y0, y1), ("grad", g0, g1)])
    return {"grad_ratio": ratio, "grad_worst_leaf": where,
            "grad_placements": str(g1.placements),
            "table_placements": str(dt.placements),
            "decode_equal": bool(torch.equal(decode.full_tensor(),
                                             table[step])),
            "columns_calls": (gathered, calls[0])}


def _compare_ssd(mesh) -> dict:
    """One Mamba block of the reduced zamba2-7b (8 heads of 32, state 16),
    a weighted sum of its output, differentiated by x and every leaf."""
    from repro_torch.models.ssm import ssd_block, ssd_init
    from repro_torch.sharding import local
    from repro_torch.sharding.rules import param_spec, shard_tree, use_mesh
    cfg = reduced(get_arch("zamba2-7b"))
    kw = dict(d_state=cfg.ssm_state, headdim=cfg.ssm_headdim,
              expand=cfg.ssm_expand)
    g = torch.Generator().manual_seed(2)
    p = ssd_init(g, cfg.d_model, device="cpu", **kw)
    x = torch.randn(B, S, cfg.d_model, generator=g)
    w = torch.randn(B, S, cfg.d_model, generator=g)
    leaves = {**p, "x": x}

    def run(tree):
        y = ssd_block({k: v for k, v in tree.items() if k != "x"},
                      tree["x"], **kw)
        names = sorted(tree)
        return y, dict(zip(names, torch.autograd.grad(
            (y * w).sum(), [tree[k] for k in names])))
    y0, g0 = run({k: v.clone().requires_grad_(True)
                  for k, v in leaves.items()})
    specs = {**param_spec(p, mesh), "x": ("data", None, None)}
    dtree = shard_tree(leaves, specs, mesh)
    for v in dtree.values():
        v.requires_grad_(True)
    with use_mesh(mesh), _counted(local, "ssd_in") as calls:
        y1, g1 = run(dtree)
    ratio, where = _max_ratio([("out", y0, y1)]
                              + [(k, g0[k], g1[k]) for k in sorted(g0)])
    return {"grad_ratio": ratio, "grad_worst_leaf": where,
            "split_calls": calls[0]}


# (KV heads, head size): on (1, 4) the cache rules shard 'model' over
# the heads, the head features, the sequence
DECODE_LAYOUTS = ((4, 32), (2, 32), (2, 6))


def _compare_decode(mesh) -> dict:
    """``layers.decode_attention`` of 2 query heads a KV head, one token a
    row at ragged cache lengths, over each of ``DECODE_LAYOUTS``."""
    from repro_torch.models.layers import decode_attention
    from repro_torch.sharding.rules import cache_spec, shard_tree, use_mesh
    g = torch.Generator().manual_seed(3)
    lens = torch.randint(1, S + 1, (B,), generator=g)
    pairs, dims = [], []
    for K, Dh in DECODE_LAYOUTS:
        q = torch.randn(B, 1, 2 * K, Dh, generator=g)
        kv = {"k": torch.randn(1, B, S, K, Dh, generator=g),
              "v": torch.randn(1, B, S, K, Dh, generator=g)}
        want = decode_attention(q, kv["k"][0], kv["v"][0], lens)
        dkv = shard_tree(kv, cache_spec(kv, mesh), mesh)
        dq = shard_tree({"q": q}, {"q": ("data", None, None, None)},
                        mesh)["q"]
        with use_mesh(mesh):
            got = decode_attention(dq, dkv["k"][0], dkv["v"][0], lens)
        pairs.append((f"K={K},Dh={Dh}", want, got))
        dims.append([p.dim if p.is_shard() else None
                     for p in dkv["k"].placements])
    ratio, where = _max_ratio(pairs)
    return {"grad_ratio": ratio, "grad_worst_leaf": where,
            "cache_placements": dims}


DECODE_STEP_ARCHS = {"step-dense-2x2": "llama-7b", "step-rwkv-2x2": "rwkv6-7b",
                     "step-zamba-2x2": "zamba2-7b"}


def _compare_decode_step(mesh, arch: str) -> dict:
    """One ``decode_step`` of the reduced ``arch`` at position 5 of a
    16-token cache of random values, meshed (the cache placed by
    ``cache_spec``, the tokens by ``batch_spec``) against un-meshed."""
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import (batch_spec, cache_spec,
                                            param_spec, shard_tree, use_mesh)
    model = build_model(reduced(get_arch(arch)), device="cpu")
    g = torch.Generator().manual_seed(4)
    params = model.init(g)
    cache = {k: torch.randn(v.shape, generator=g, dtype=v.dtype)
             if v.is_floating_point() else v
             for k, v in model.init_cache(B, S).items()}
    token = torch.randint(0, model.cfg.vocab_size, (B, 1), generator=g)
    want, c0 = model.decode_step(params, {k: v.clone()
                                          for k, v in cache.items()},
                                 token, 5)
    dparams = shard_tree(params, param_spec(params, mesh), mesh)
    dcache = shard_tree(cache, cache_spec(cache, mesh), mesh)
    dtoken = shard_tree({"t": token}, batch_spec({"t": token}, mesh),
                        mesh)["t"]
    with use_mesh(mesh):
        got, c1 = model.decode_step(dparams, dcache, dtoken, 5)
    ratio, where = _max_ratio([("logits", want, got)]
                              + [(k, c0[k], c1[k]) for k in sorted(c0)])
    return {"grad_ratio": ratio, "grad_worst_leaf": where,
            "leaves": len(c0)}


EXTRA_CASES = {
    "dense-2x1x2": "3-D mesh (pod, data, model)",
    "embed-2x2": "vocabulary-parallel embed_rows",
    "ssd-1x4": "Mamba block, heads over 4 'model' ranks",
    "ssd-2x2": "Mamba block on (2, 2)",
    "decode-1x4": "decode attention over three cache layouts",
    **{k: f"decode_step of {a}" for k, a in DECODE_STEP_ARCHS.items()},
}


def _extra(name: str) -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    if name == "dense-2x1x2":
        mesh = make_production_mesh(multi_pod=True, shape=(2, 1, 2),
                                    device_type="cpu")
        return _compare(reduced(get_arch("llama-7b")), mesh)
    shape = tuple(int(d) for d in name.split("-")[-1].split("x"))
    mesh = make_production_mesh(shape=shape, device_type="cpu")
    if name in DECODE_STEP_ARCHS:
        return _compare_decode_step(mesh, DECODE_STEP_ARCHS[name])
    compare = {"embed": _compare_embed, "ssd": _compare_ssd,
               "decode": _compare_decode}[name.split("-")[0]]
    return compare(mesh)


def _worker(rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_production_mesh(shape=(2, 2), device_type="cpu")
        results = {}
        for name, cfg in _cases().items():
            try:
                results[name] = _compare(cfg, mesh)
            except Exception:           # reported by the case's test
                results[name] = {"error": traceback.format_exc()}
        moe = reduced(get_arch("granite-moe-1b-a400m"))
        for name, (shape, cf, rows) in _moe_cases().items():
            try:
                mesh = make_production_mesh(shape=shape, device_type="cpu")
                results[name] = _compare_moe(moe, mesh, cf, rows)
            except Exception:           # reported by the case's test
                results[name] = {"error": traceback.format_exc()}
        for name in EXTRA_CASES:
            try:
                results[name] = _extra(name)
            except Exception:           # reported by the case's test
                results[name] = {"error": traceback.format_exc()}
        if rank == 0:
            with open(out, "w") as fh:
                json.dump(results, fh)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory) -> dict:
    out = str(tmp_path_factory.mktemp("sharded") / "results.json")
    torch.multiprocessing.spawn(_worker, args=(4, _free_port(), out),
                                nprocs=4, join=True)
    with open(out) as fh:
        return json.load(fh)


@pytest.mark.parametrize("case", list(_cases()))
def test_meshed_loss_and_grads_match_unmeshed(results, case):
    r = results[case]
    assert "error" not in r, r.get("error")
    assert abs(r["loss_meshed"] - r["loss"]) <= LOSS_RTOL * abs(r["loss"]), r
    assert r["grad_ratio"] <= 1.0, r
    assert r["leaves"] > 0


@pytest.mark.parametrize("case", list(_moe_cases()))
def test_meshed_moe_dispatch_matches_unmeshed(results, case):
    """Each rank routes its own tokens: the loss and gradients by the rule
    above, the experts and the kept pairs exactly the un-meshed ones, and
    with a capacity a pair dropped because of the ranks before it where
    more than one rank's window holds tokens."""
    r = results[case]
    assert "error" not in r, r.get("error")
    assert abs(r["loss_meshed"] - r["loss"]) <= LOSS_RTOL * abs(r["loss"]), r
    assert r["grad_ratio"] <= 1.0, r
    assert r["layers"] > 0 and r["keep_equal"], r
    if r["capacity"] is not None and r["windows"] > 1:
        assert r["dropped_across"] > 0, r


def test_dense_loss_on_the_3d_mesh_matches_unmeshed(results):
    """The reduced dense model on (pod, data, model) = (2, 1, 2): the
    batch over 'pod', the head's product and the loss vocabulary-parallel
    over 'model'."""
    r = results["dense-2x1x2"]
    assert "error" not in r, r.get("error")
    assert abs(r["loss_meshed"] - r["loss"]) <= LOSS_RTOL * abs(r["loss"]), r
    assert r["grad_ratio"] <= 1.0, r


def test_vocab_parallel_embed_rows_matches_unmeshed(results):
    """The lookup and the table's gradient by the rule; the gradient comes
    back as the table's own shard; the decode-step lookup exactly."""
    r = results["embed-2x2"]
    assert "error" not in r, r.get("error")
    assert r["grad_ratio"] <= 1.0, r
    assert r["grad_placements"] == r["table_placements"], r
    assert r["decode_equal"], r
    # the table gathered under grad, the ids gathered for the decode step
    assert r["columns_calls"] == [0, 1], r


@pytest.mark.parametrize("case", ["ssd-1x4", "ssd-2x2"])
def test_sharded_mamba_split_matches_unmeshed(results, case):
    r = results[case]
    assert "error" not in r, r.get("error")
    assert r["grad_ratio"] <= 1.0, r
    assert r["split_calls"] == 1, r


def test_decode_attention_matches_unmeshed_every_cache_layout(results):
    """The output by the rule, and the three layouts really exercised:
    'model' (mesh dimension 1) shards the stacked cache's heads (3), head
    features (4) and sequence (2)."""
    r = results["decode-1x4"]
    assert "error" not in r, r.get("error")
    assert r["grad_ratio"] <= 1.0, r
    assert [d[1] for d in r["cache_placements"]] == [3, 4, 2], r


@pytest.mark.parametrize("case", list(DECODE_STEP_ARCHS))
def test_meshed_decode_step_matches_unmeshed(results, case):
    r = results[case]
    assert "error" not in r, r.get("error")
    assert r["grad_ratio"] <= 1.0, r
    assert r["leaves"] > 0
