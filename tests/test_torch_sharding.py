"""The port's sharding rules against the reference's, leaf by leaf.

For every config in ``ARCHS`` on five meshes, the specs of the port's
parameters, AdamW moments, batches (every applicable shape) and decode
caches equal the reference's ``PartitionSpec``s, built on a
``jax.sharding.AbstractMesh`` from ``jax.eval_shape`` trees; the port's
trees are built on the meta device. Each leaf's local shard bytes equal
the reference's ``NamedSharding.shard_shape`` bytes. A spec shorter than
its leaf is padded with ``None``, as ``PartitionSpec`` reads it.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import (ARCHS as REF_ARCHS, SHAPES as REF_SHAPES,
                           applicable_shapes as ref_applicable,
                           input_specs as ref_input_specs)
from repro.models import build_model as ref_build_model
from repro.sharding import rules as ref_rules
from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, input_specs
from repro_torch.models import build_model
from repro_torch.sharding import rules
from repro_torch.train.optim import AdamW
from repro_torch.train.tree import flatten

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "32x8": ((32, 8), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}


def _ref_flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", k)) for k in path)] = leaf
    return out


@functools.lru_cache(maxsize=None)
def _ref_trees(arch: str):
    cfg = REF_ARCHS[arch]
    model = ref_build_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    caches = {}
    for s in ref_applicable(cfg):
        shape = REF_SHAPES[s]
        if shape.kind == "decode":
            B, S = shape.global_batch, shape.seq_len
            caches[s] = jax.eval_shape(
                (lambda: model.init_cache(B, S, S)) if cfg.family == "encdec"
                else (lambda: model.init_cache(B, S)))
    return params, caches


@functools.lru_cache(maxsize=None)
def _port_trees(arch: str):
    cfg = ARCHS[arch]
    model = build_model(cfg, device="meta")
    params = model.init(torch.Generator())
    caches = {}
    for s in applicable_shapes(cfg):
        shape = SHAPES[s]
        if shape.kind == "decode":
            B, S = shape.global_batch, shape.seq_len
            caches[s] = (model.init_cache(B, S, S) if cfg.family == "encdec"
                         else model.init_cache(B, S))
    return params, caches


def _local_shape(shape: tuple, spec, sizes: dict) -> tuple:
    """One device's shard of ``shape`` under ``spec`` (every axis an entry
    names divides its dimension)."""
    out = []
    for dim, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        out.append(dim // rules.axis_size(sizes, *axes))
    return tuple(out)


def _padded(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def _check(label: str, port_specs, port_tree, ref_shardings, ref_tree,
           sizes: dict) -> int:
    """Spec and local shard bytes of every leaf; returns the leaf count."""
    ps, pt = dict(flatten(port_specs)), dict(flatten(port_tree))
    rs, rt = _ref_flat(ref_shardings), _ref_flat(ref_tree)
    assert sorted(ps) == sorted(rs), label
    for path, ref_sh in rs.items():
        ref_leaf, leaf = rt[path], pt[path]
        assert tuple(leaf.shape) == tuple(ref_leaf.shape), (label, path)
        nd = len(ref_leaf.shape)
        assert _padded(ps[path], nd) == _padded(ref_sh.spec, nd), \
            (label, path, ps[path], ref_sh.spec)
        ref_bytes = int(np.prod(ref_sh.shard_shape(ref_leaf.shape))) \
            * np.dtype(ref_leaf.dtype).itemsize
        got = int(np.prod(_local_shape(tuple(leaf.shape), ps[path],
                                       sizes))) * leaf.element_size()
        assert got == ref_bytes, (label, path, got, ref_bytes)
    return len(rs)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_specs_equal_reference(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    ref_mesh = AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    ref_params, ref_caches = _ref_trees(arch)
    params, caches = _port_trees(arch)

    n = _check("params", rules.param_spec(params, sizes), params,
               ref_rules.param_sharding(ref_params, ref_mesh), ref_params,
               sizes)
    assert n > 0
    # the optimizer's moments: the reference shards them as parameters
    state = {"params": params, "opt": AdamW().init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    st = rules.state_spec(state, sizes)
    ref_m = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, np.float32),
                         ref_params)
    for k in ("m", "v"):
        _check(f"opt/{k}", st["opt"][k], state["opt"][k],
               ref_rules.param_sharding(ref_m, ref_mesh), ref_m, sizes)
    assert st["step"] == () and st["opt"]["count"] == ()

    cfg, ref_cfg = ARCHS[arch], REF_ARCHS[arch]
    assert applicable_shapes(cfg) == ref_applicable(ref_cfg)
    for s in applicable_shapes(cfg):
        batch = input_specs(cfg, SHAPES[s])
        ref_batch = ref_input_specs(ref_cfg, REF_SHAPES[s])
        _check(f"batch {s}", rules.batch_spec(batch, sizes), batch,
               ref_rules.batch_sharding(ref_batch, ref_mesh), ref_batch,
               sizes)
        if s in caches:
            _check(f"cache {s}", rules.cache_spec(caches[s], sizes),
                   caches[s], ref_rules.cache_sharding(ref_caches[s],
                                                       ref_mesh),
                   ref_caches[s], sizes)


class _Mesh:
    """The names and sizes ``to_placements`` reads of a DeviceMesh."""

    def __init__(self, names, sizes):
        self.mesh_dim_names, self._sizes = names, sizes

    def size(self, i):
        return self._sizes[i]


def test_to_placements_mesh_order():
    """('pod', 'data') on one dimension is Shard(d) on both mesh dims;
    axes the mesh lacks, and axes of one device, are dropped."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _Mesh(("pod", "data", "model"), (2, 16, 16))
    pl = rules.to_placements((("pod", "data"), None, "model"), mesh)
    assert pl == (Shard(0), Shard(0), Shard(2))
    mesh = _Mesh(("data", "model"), (2, 2))
    assert rules.to_placements((("pod", "data"), "model"), mesh) == \
        (Shard(0), Shard(1))
    assert rules.to_placements((None, None), mesh) == \
        (Replicate(), Replicate())
    assert rules.to_placements(("data", "model"), _Mesh(
        ("data", "model"), (1, 1))) == (Replicate(), Replicate())


def test_constrain_identity_unmeshed():
    x = torch.ones(4, 8)
    assert rules.active_mesh() is None
    assert rules.constrain(x, ("pod", "data"), "model") is x
