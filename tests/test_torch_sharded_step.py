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
"""
from __future__ import annotations

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
