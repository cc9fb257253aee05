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


def _batch(cfg) -> dict:
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])}
    if cfg.family == "encdec":
        batch["encoder_embeds"] = torch.from_numpy(
            rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32))
    if cfg.frontend == "vit":
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    return batch


def _compare(cfg, mesh) -> dict:
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import (batch_spec, param_spec,
                                            shard_tree, use_mesh)
    from repro_torch.train.step import value_and_grad
    from repro_torch.train.tree import flatten

    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg)
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
