"""Sharding rules: the port of ``repro/sharding/rules.py`` on DTensor.

The rules are the reference's, as pure functions of a leaf's key path and
shape and the mesh's axis sizes: parameters take TP over ``'model'`` and
FSDP over ``'data'`` (DP over ``'pod'``), batches shard dim 0 over
``('pod', 'data')``, decode caches shard batch over ``('pod', 'data')``
and heads (else the head features, else the sequence) over ``'model'``,
each axis dropped where it does not divide. A spec is a tuple with one
entry a dimension: ``None``, an axis name, or a tuple of names, as the
reference's ``PartitionSpec``. :func:`param_spec`, :func:`batch_spec`,
:func:`cache_spec` and :func:`state_spec` return trees of specs;
:func:`to_placements` turns one into DTensor placements (a dimension
sharded over ``('pod', 'data')`` becomes ``Shard(d)`` on both mesh
dimensions, in mesh order), and :func:`param_sharding`,
:func:`batch_sharding`, :func:`cache_sharding` return placements for a
``DeviceMesh``. :func:`shard_tree` makes DTensors of a tree of tensors.

:func:`constrain` is the reference's ``with_sharding_constraint`` with
fallbacks; :func:`use_mesh` makes a mesh the active one, as
``jax.set_mesh`` does. Without an active mesh ``constrain`` returns its
input after one test of a module global, and nothing of
``torch.distributed`` is imported: the un-meshed paths do not change.
A "mesh" for the pure functions is a ``DeviceMesh`` or a dict of axis
sizes.
"""
from __future__ import annotations

import contextlib
import re
from typing import Any

import torch

__all__ = ["param_spec", "batch_spec", "cache_spec", "state_spec",
           "to_placements", "param_sharding", "batch_sharding",
           "cache_sharding", "shard_tree", "axis_size", "constrain",
           "use_mesh", "active_mesh", "meshed", "split_last",
           "split_dim", "merge_last", "embed_rows", "unembed",
           "shard_dim", "fsdp_gather"]

Spec = tuple

_MESH = None          # the active DeviceMesh (use_mesh), visible to every
                      # thread: the backward and its recompute may run on
                      # the autograd engine's device threads


def _shape(mesh) -> dict[str, int]:
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, *names: str) -> int:
    sizes = _shape(mesh)
    n = 1
    for nm in names:
        n *= sizes.get(nm, 1)
    return n


def _div(dim: int, n: int) -> bool:
    return n > 0 and dim % n == 0


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _shape(mesh))


def _entry(axes: tuple[str, ...]):
    """A spec entry as ``PartitionSpec`` normalises it: one axis is its
    name."""
    return axes[0] if len(axes) == 1 else axes


# ---------------------------------------------------------------- params
_2D_IN_OUT = ("data", "model")      # [d_in, d_out]
_2D_OUT_IN = ("model", "data")      # [d_out (model-sharded contracting), d_in]

_PARAM_RULES: dict[str, dict[int, tuple]] = {
    "embed": {2: ("model", "data")},          # [Vp, D] vocab -> TP
    "unembed": {2: ("data", "model")},        # [D, Vp]
    "wq": {2: _2D_IN_OUT}, "wk": {2: _2D_IN_OUT, 3: ("model", "data", None)},
    "wv": {2: _2D_IN_OUT},
    "wo": {2: _2D_OUT_IN, 3: ("model", None, "data")},   # 3D: experts' out
    "bq": {1: ("model",)}, "bk": {1: ("model",)}, "bv": {1: ("model",)},
    "wi": {2: _2D_IN_OUT}, "wi_gate": {2: _2D_IN_OUT, 3: ("model", "data", None)},
    "wi_up": {2: _2D_IN_OUT, 3: ("model", "data", None)},
    "bi": {1: ("model",)}, "bo": {1: (None,)},
    "router": {2: ("data", None)},
    "wr": {2: _2D_IN_OUT}, "wg": {2: _2D_IN_OUT}, "cr": {2: _2D_IN_OUT},
    "ck": {2: _2D_IN_OUT}, "cv": {2: _2D_OUT_IN},
    "in_proj": {2: _2D_IN_OUT}, "out_proj": {2: _2D_OUT_IN},
    "conv_w": {2: (None, "model")}, "conv_b": {1: ("model",)},
    "norm_g": {1: ("model",)},
}


def _rule_spec(name: str, shape: tuple[int, ...], mesh,
               stacked: int) -> list:
    rule = _PARAM_RULES.get(name, {}).get(len(shape) - stacked)
    if rule is None:
        return []               # replicated: norm gains, LoRAs, small leaves
    spec: list[Any] = [None] * stacked
    for dim, ax in zip(shape[stacked:], rule):
        spec.append(ax if ax is not None
                    and _div(dim, axis_size(mesh, *_axes(ax))) else None)
    return spec


def _leaf_param_spec(path: str, shape: tuple[int, ...], mesh) -> Spec:
    names = path.split("/")
    leafname = names[-1].lstrip("_")
    stacked = 0
    if re.search(r"(^|/)(layers|enc_layers|dec_layers|mamba_tail)(/|$)",
                 path):
        stacked = 1
    elif re.search(r"(^|/)mamba(/|$)", path):
        stacked = 2             # [n_groups, group, ...]
    elif leafname == "shared_adapters":
        stacked = 1
    if re.match(r"ln\d?_?.*", leafname) or leafname.endswith("_g") \
            and leafname not in _PARAM_RULES:
        spec: list[Any] = [None] * stacked
    else:
        spec = _rule_spec(leafname, shape, mesh, stacked)
    spec += [None] * (len(shape) - len(spec))
    if "/shared/" in f"/{path}/":
        # zamba's shared block, called at every group: 'model' only
        spec = [None if ax == "data" else ax for ax in spec]
    return tuple(spec)


def _map_path(fn, tree: Any, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_spec(params: Any, mesh) -> Any:
    """A tree of specs for a parameter tree (of tensors, meta tensors or
    anything with ``.shape``). Stacked layers are found by their path:
    ``layers``, ``enc_layers``, ``dec_layers``, ``mamba_tail`` (one
    leading axis), ``mamba`` (two), ``shared_adapters``."""
    return _map_path(lambda p, t: _leaf_param_spec(p, tuple(t.shape), mesh),
                     params)


def state_spec(state: Any, mesh) -> Any:
    """Specs of a train state ``{"params", "opt", "step"}``: the moments of
    the optimizer as their parameters, scalars replicated."""
    def opt(tree):
        return {k: (param_spec(v, mesh) if isinstance(v, dict)
                    else _replicated(v)) for k, v in tree.items()}
    return {"params": param_spec(state["params"], mesh),
            "opt": opt(state["opt"]),
            "step": _replicated(state["step"])}


def _replicated(t) -> Spec:
    return (None,) * len(t.shape)


# ---------------------------------------------------------------- batches
def _batch_leaf(shape: tuple[int, ...], mesh) -> Spec:
    if not shape:
        return ()
    rest = (None,) * (len(shape) - 1)
    daxes = _data_axes(mesh)
    if _div(shape[0], axis_size(mesh, *daxes)):
        return (_entry(daxes), *rest)
    if "data" in _shape(mesh) and _div(shape[0], axis_size(mesh, "data")):
        return ("data", *rest)
    return (None, *rest)


def batch_spec(batch: Any, mesh) -> Any:
    """Dim 0 over ``('pod', 'data')`` when it divides, else ``'data'``
    alone, else replicated."""
    return _map_path(lambda p, t: _batch_leaf(tuple(t.shape), mesh), batch)


# ---------------------------------------------------------------- caches
# per key: (head dim, head-feature dim, sequence dim) in the unstacked
# suffix from batch (position 0); -1 = absent. The 'model' axis goes to the
# first that divides.
_CACHE_LAYOUT: dict[str, tuple[int, int, int]] = {
    "k": (2, 3, 1), "v": (2, 3, 1),       # [B, S, K, Dh]
    "wkv": (1, -1, -1),                    # [B, H, P, P]
    "ssm": (1, -1, -1),                    # [B, H, P, N]
    "conv": (-1, -1, -1),                  # [B, dconv-1, convdim]
    "ssm_tail": (1, -1, -1), "conv_tail": (-1, -1, -1),
    "tm_shift": (-1, -1, -1), "cm_shift": (-1, -1, -1),
    "enc_out": (-1, -1, 1),                # [B, S_enc, D]
    "k_scale": (2, -1, 1), "v_scale": (2, -1, 1),   # int8-KV scales [B,S,K]
}
_STACK_AXES = {"k": 1, "v": 1, "wkv": 1, "ssm": 2, "conv": 2,
               "ssm_tail": 1, "conv_tail": 1, "tm_shift": 1, "cm_shift": 1,
               "enc_out": 0, "k_scale": 1, "v_scale": 1}


def _cache_leaf(key: str, shape: tuple[int, ...], mesh) -> Spec:
    spec: list[Any] = [None] * len(shape)
    if key not in _CACHE_LAYOUT:
        return tuple(spec)
    stacked = _STACK_AXES[key]
    if stacked >= len(shape):
        return tuple(spec)
    daxes = _data_axes(mesh)
    if _div(shape[stacked], axis_size(mesh, *daxes)):
        spec[stacked] = _entry(daxes)
    elif "data" in _shape(mesh) and _div(shape[stacked],
                                         axis_size(mesh, "data")):
        spec[stacked] = "data"
    nm = axis_size(mesh, "model")
    for cand in _CACHE_LAYOUT[key]:
        dim = stacked + cand
        if cand >= 0 and dim < len(shape) and _div(shape[dim], nm):
            spec[dim] = "model"
            break
    return tuple(spec)


def cache_spec(cache: Any, mesh) -> Any:
    """Decode caches: batch over ``('pod', 'data')`` where it divides;
    heads over ``'model'`` where they divide, else the head features, else
    the sequence."""
    return _map_path(lambda p, t: _cache_leaf(p.split("/")[-1],
                                              tuple(t.shape), mesh), cache)


# ---------------------------------------------------------- placements
def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): mesh
    dimension i is ``Shard(d)`` when tensor dimension d names its axis,
    else ``Replicate()``. Axes the mesh lacks are dropped, and so are axes
    of one device: a shard of all of a dimension is a replica, and a
    one-device mesh then runs every op as its plain tensors would."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            if a in names and mesh.size(names.index(a)) > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def _placements(specs: Any, mesh) -> Any:
    return _map_path(lambda p, s: to_placements(s, mesh), specs)


def param_sharding(params: Any, mesh) -> Any:
    """Placements of every parameter on ``mesh``."""
    return _placements(param_spec(params, mesh), mesh)


def batch_sharding(batch: Any, mesh) -> Any:
    return _placements(batch_spec(batch, mesh), mesh)


def cache_sharding(cache: Any, mesh) -> Any:
    return _placements(cache_spec(cache, mesh), mesh)


def _local_slice(t: torch.Tensor, placements: tuple, mesh) -> torch.Tensor:
    """This rank's shard of the global tensor ``t`` (the rules shard only
    dimensions that divide, so the shards are even)."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(i)
            size = t.shape[pl.dim] // n
            t = t.narrow(pl.dim, coord[i] * size, size)
    return t


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """DTensors of ``tree``'s leaves, each sharded by its spec in
    ``specs``. A leaf holds the global tensor on every rank (drawn from
    one seed); each rank keeps its own shard, without a collective. A meta
    leaf becomes a meta shard of the local shape. On a mesh of one device
    the DTensor wraps the leaf itself: no copy."""
    from torch.distributed.tensor import DTensor

    def one(path, t):
        spec = _at(specs, path)
        pl = to_placements(spec, mesh)
        if t.device.type == "meta":
            local = _local_slice(t, pl, mesh)
            local = torch.empty(local.shape, dtype=t.dtype, device="meta")
        else:
            local = _local_slice(t, pl, mesh)
            if mesh.size() > 1:
                local = local.contiguous()
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return _map_path(one, tree)


def _at(tree: Any, path: str) -> Any:
    for k in path.split("/") if path else ():
        tree = tree[k]
    return tree


# ------------------------------------------------------------- constrain
class _ImplicitReplication(torch.autograd.Function):
    """The identity, whose backward allows DTensor to treat plain tensors
    as replicated in the thread that runs it: on CUDA the backward, and
    the recompute of a checkpointed layer, run on the autograd engine's
    device thread, where the forward thread's setting does not reach (on
    the CPU and the meta device they run in the calling thread)."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, dy):
        from torch.distributed.tensor import DTensor
        DTensor._op_dispatcher._allow_implicit_replication = True
        return dy


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` with the production axis names) the
    active one, as ``jax.set_mesh`` does: :func:`constrain` places
    activations on it, the kernels' call sites run on their local shards
    (:mod:`.local`), and plain tensors meet DTensors as replicated ones."""
    from torch.distributed.tensor.experimental import implicit_replication
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESH = prev


def active_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _MESH


def meshed(x) -> bool:
    """Whether a kernel's call site must run on ``x``'s local shards: a
    mesh is active and ``x`` is a DTensor. Un-meshed, one test of a
    module global."""
    if _MESH is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *spec, require: str | None = None):
    """``with_sharding_constraint`` with the reference's fallbacks: axes
    the active mesh lacks, or that do not divide their dimension, are
    dropped; with ``require='model'``, if that axis places on no
    dimension, ``x`` is returned unchanged (pinning the tensor to
    replication would cost more than leaving it). The identity without an
    active mesh or when ``x`` is not a DTensor; else ``x`` redistributed
    to the spec's placements."""
    if _MESH is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sizes = _shape(mesh)
    fixed: list[Any] = []
    placed: set[str] = set()
    for dim, sp in zip(x.shape, spec):
        cand = tuple(a for a in _axes(sp) if a in sizes)
        if not cand or not _div(dim, axis_size(mesh, *cand)):
            fixed.append(None)
            continue
        placed.update(cand)
        fixed.append(cand)
    if require is not None and require not in placed:
        return x
    fixed += [None] * (x.dim() - len(fixed))
    pl = to_placements(tuple(fixed), mesh)
    if x.requires_grad and x.device.type == "cuda":
        x = _ImplicitReplication.apply(x)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def split_last(x, *shape):
    """``x.reshape(*shape)``, which splits the last dimension into the
    last two of ``shape`` (``[..., H * Dh]`` into ``[..., H, Dh]``); see
    :func:`split_dim`."""
    if _MESH is not None:
        x = split_dim(x, x.dim() - 1, shape[-2])
    return x.reshape(*shape)


def shard_dim(p) -> int | None:
    """The tensor dimension a placement shards (a ``Shard`` or the
    ``_StridedShard`` of a flattened dimension, which is not a ``Shard``),
    or None."""
    from torch.distributed.tensor.placement_types import _StridedShard
    return p.dim if p.is_shard() or isinstance(p, _StridedShard) else None


def split_dim(x, dim: int, outer: int):
    """``x``, ready to have dimension ``dim`` split into ``outer`` groups by
    a reshape. Under a mesh, a mesh dimension that shards ``dim`` into
    pieces that do not hold whole groups (2 KV heads over 16 'model'
    ranks) is gathered first, as GSPMD would."""
    if _MESH is not None and meshed(x):
        mesh = x.device_mesh
        pl = list(x.placements)
        for i, p in enumerate(pl):
            if shard_dim(p) in (dim, dim - x.dim()) \
                    and not _div(outer, mesh.size(i)):
                from torch.distributed.tensor import Replicate
                pl[i] = Replicate()
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x


class _SplitGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient ready to be split
    into ``outer`` groups along its last dimension (:func:`split_dim`)."""

    @staticmethod
    def forward(ctx, x, outer):
        ctx.outer = outer
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return split_dim(dy, dy.dim() - 1, ctx.outer), None


def merge_last(x, *shape):
    """``x.reshape(*shape)``, which merges the last two dimensions of ``x``
    (``[..., H, Dh]`` into ``[..., H * Dh]``). Under a mesh the backward,
    which splits the gradient again, first gathers a mesh dimension that
    shards it into pieces of no whole head (:func:`split_dim`)."""
    y = x.reshape(*shape)
    if meshed(y) and y.requires_grad:
        y = _SplitGrad.apply(y, x.shape[-2])
    return y


def embed_rows(table, ids):
    """``table[ids]``: the rows of an embedding table. Under a mesh of
    more than one device the lookup runs on the local shards
    (``sharding.local.embed``): the table keeps its vocabulary shard over
    ``'model'``, only its FSDP shard is gathered, and the rows looked up
    on each shard are summed over ``'model'``; its gradient comes back as
    a shard. DTensor's own strategies for indexing a sharded table, and
    for the backward of ``table[ids]``, fail in their redistributions."""
    if meshed(table) and table.device_mesh.size() > 1:
        from .local import embed
        return embed(table, ids)
    return table[ids]


def unembed(h, w):
    """``h @ w``, the head's product of h [B, S, D] and the unembedding
    [D, V]: logits over the batch and, under a mesh, the vocabulary over
    ``'model'``. Under a mesh of more than one device the product runs on
    the local shards (``sharding.local.head``), so that no rank holds a
    row of logits over the whole vocabulary and DTensor plans no strategy
    of its own for it."""
    if meshed(h) and h.device_mesh.size() > 1:
        from .local import head
        return head(h, w)
    return constrain(h @ fsdp_gather(w), ("pod", "data"), None, "model")


def fsdp_gather(w):
    """A parameter as a layer uses it: its shards over the data axes
    (``'pod'``, ``'data'``: ZeRO-3's FSDP shard) gathered, the tensor
    parallelism over ``'model'`` kept, as the reference's rules intend
    ("all-gathered per layer under scan"). The gradient is reduce-scattered
    back by the redistribution's backward. The identity un-meshed, on a
    plain tensor, or where no data axis of more than one device shards
    it."""
    if not meshed(w):
        return w
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    pl = [p for p in w.placements]
    for i, p in enumerate(pl):
        if names[i] in ("pod", "data") and mesh.size(i) > 1 \
                and shard_dim(p) is not None:
            from torch.distributed.tensor import Replicate
            pl[i] = Replicate()
    if pl == list(w.placements):
        return w
    return w.redistribute(mesh, pl)
