"""The kernels' call sites under a mesh: each hand-written kernel runs on
its local shards, through ``local_map``, in a layout where its work is
local, and the wrapper inside is the un-meshed one (on a CUDA tensor it
launches or raises).

* rmsnorm: rows. The normalised dimension is replicated; dγ is a partial
  sum over the mesh dimensions that split the rows.
* flash attention (forward and backward): batch over ``('pod', 'data')``,
  heads over ``'model'`` (the reference's head-sharded attention,
  ``repro/models/layers.py:177-180``). Where the KV heads do not divide
  ``'model'`` but the query heads do, K and V stay replicated over
  ``'model'`` and each rank slices the KV heads its query heads read (one
  head when a group spans several ranks); their gradients are partial
  sums over ``'model'``. Where neither divides, heads stay replicated.
* ssd_scan and wkv6: batch and heads; SSD's B and C, shared by the heads,
  are replicated over ``'model'`` with partial-sum gradients.
* the decode cache's write (``layers.cache_put``): each rank writes the
  rows of its batch shard, at their positions where its shard of the
  sequence holds them, into its shard of the heads and features.
* grouped matmul: experts over ``'model'`` (when they divide), tokens
  over the other mesh dimensions. Each rank routes only its own tokens
  (its batch shard; the ranks along a dimension that does not split the
  batch share it by windows) and computes the rows of its experts. An
  all-gather of the per-expert pair counts over the token dimensions
  gives each pair its place in its expert's queue across the whole batch,
  so a capacity drops what it drops un-meshed (:class:`MoEShard`). The
  outputs stay batch-sharded, partial sums over the dimensions that split
  the experts or share the tokens; the MoE aux loss is a partial sum over
  the whole mesh (``models/layers.py::moe_block``).

Batch dimensions shard as the batch rule does (``rules.batch_spec``):
over ``('pod', 'data')`` when that divides, else ``'data'``, else not.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .rules import _data_axes, _div, axis_size

__all__ = ["rmsnorm", "attention", "ssd_scan", "wkv6", "moe_experts",
           "MoEShard", "cache_put"]


def _batch_dims(mesh, B: int) -> tuple[int, ...]:
    """Mesh dimensions over which a batch of B rows shards."""
    names = list(mesh.mesh_dim_names)
    daxes = _data_axes(mesh)
    if _div(B, axis_size(mesh, *daxes)):
        return tuple(names.index(a) for a in daxes)
    if "data" in names and _div(B, axis_size(mesh, "data")):
        return (names.index("data"),)
    return ()


def _model_dim(mesh, *counts: int):
    """The mesh dimension of 'model' when every count divides it."""
    names = list(mesh.mesh_dim_names)
    if "model" not in names:
        return None
    m = names.index("model")
    return m if all(_div(c, mesh.size(m)) for c in counts) else None


def _pl(mesh, shards: dict[int, int]) -> tuple:
    """Placements: ``shards`` maps a mesh dimension to a tensor
    dimension; the other mesh dimensions, and those of one device,
    replicate (``rules.to_placements``)."""
    return tuple(Shard(shards[i]) if i in shards and mesh.size(i) > 1
                 else Replicate() for i in range(mesh.ndim))


def _partial_over(mesh, pl: tuple, dims) -> tuple:
    """``pl`` with the mesh dimensions ``dims`` partial sums (the local
    gradients of a replicated input whose use those dimensions split);
    a dimension of one device keeps its placement."""
    return tuple(Partial() if i in dims and mesh.size(i) > 1 else p
                 for i, p in enumerate(pl))


def rmsnorm(fn, x, g, eps):
    """``fn(x, g, eps)`` (the un-meshed norm) on rows."""
    mesh = x.device_mesh
    last = x.dim() - 1
    # the rows stay where they are, but for a strided shard (a flattened
    # dimension's), from whose local shape local_map could not infer the
    # global one
    xpl = tuple(p if p.is_shard() and p.dim not in (last, -1)
                or p.is_replicate() else Replicate() for p in x.placements)
    rep = (Replicate(),) * mesh.ndim
    split = [i for i, p in enumerate(xpl) if p.is_shard()]
    return local_map(fn, out_placements=list(xpl), in_placements=(xpl, rep, None),
                     in_grad_placements=(xpl, _partial_over(mesh, rep, split),
                                         None),
                     redistribute_inputs=True)(x, g, eps)


def attention(fn, q, k, v, causal: bool, q_offset: int):
    """``fn(q, k, v, causal, q_offset)`` (the un-meshed attention) with
    batch and heads local."""
    mesh = q.device_mesh
    B, _, Hq, _ = q.shape
    Hkv = k.shape[2]
    shards = {i: 0 for i in _batch_dims(mesh, B)}
    qs, kvs = dict(shards), dict(shards)
    m = _model_dim(mesh, Hq)
    slice_kv = False
    if m is not None:
        hq = Hq // mesh.size(m)
        G = Hq // Hkv
        if _div(Hkv, mesh.size(m)):
            qs[m] = kvs[m] = 2
        elif hq % G == 0 or G % hq == 0:
            qs[m] = 2
            slice_kv = True
    qpl, kvpl = _pl(mesh, qs), _pl(mesh, kvs)
    kv_grad = _partial_over(mesh, kvpl, [m]) if slice_kv else kvpl

    def local(ql, kl, vl):
        if slice_kv:
            G = Hq // Hkv
            hq = ql.shape[2]
            r = mesh.get_local_rank(m)
            lo, hi = r * hq // G, ((r + 1) * hq - 1) // G + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return fn(ql, kl, vl, causal, q_offset)
    return local_map(local, out_placements=list(qpl),
                     in_placements=(qpl, kvpl, kvpl),
                     in_grad_placements=(qpl, kv_grad, kv_grad),
                     redistribute_inputs=True)(q, k, v)


def ssd_scan(fn, xh, dt, A, Bm, Cm, chunk: int):
    """``fn(xh, dt, A, Bm, Cm, chunk=chunk)`` with batch and heads local."""
    mesh = xh.device_mesh
    B, _, H, _ = xh.shape
    bat = {i: 0 for i in _batch_dims(mesh, B)}
    m = _model_dim(mesh, H)
    heads = dict(bat)
    if m is not None:
        heads[m] = 2
    xpl = _pl(mesh, heads)
    apl = _pl(mesh, {m: 0} if m is not None else {})
    bpl = _pl(mesh, bat)
    bgrad = _partial_over(mesh, bpl, [m] if m is not None else [])
    agrad = _partial_over(mesh, apl, list(bat))
    return local_map(lambda *a: fn(*a, chunk=chunk), out_placements=list(xpl),
                     in_placements=(xpl, xpl, apl, bpl, bpl),
                     in_grad_placements=(xpl, xpl, agrad, bgrad, bgrad),
                     redistribute_inputs=True)(xh, dt, A, Bm, Cm)


def wkv6(fn, r, k, v, lw, u, chunk: int):
    """``fn(r, k, v, lw, u, chunk=chunk)`` with batch and heads local."""
    mesh = r.device_mesh
    B, _, H, _ = r.shape
    m = _model_dim(mesh, H)
    bat = _batch_dims(mesh, B)
    shards = {i: 0 for i in bat}
    if m is not None:
        shards[m] = 2
    xpl = _pl(mesh, shards)
    upl = _pl(mesh, {m: 0} if m is not None else {})
    ugrad = _partial_over(mesh, upl, list(bat))
    return local_map(lambda *a: fn(*a, chunk=chunk), out_placements=list(xpl),
                     in_placements=(xpl, xpl, xpl, xpl, upl),
                     in_grad_placements=(xpl, xpl, xpl, xpl, ugrad),
                     redistribute_inputs=True)(r, k, v, lw, u)


class MoEShard:
    """One rank's part of a meshed MoE block (``layers._moe_rows``):
    ``experts = (e0, e1)``, the experts whose weights it holds;
    ``window = (w0, w1)``, the flattened local tokens it routes (all of its
    batch shard, or its share where ranks along a token dimension that does
    not split the batch hold the same rows); ``n_tokens``, the batch's
    tokens; ``start``, where its window begins in the batch's flattened
    token order."""

    def __init__(self, mesh, m, bat: list[int], rep: list[int],
                 n_experts: int, n_tokens: int, local_tokens: int) -> None:
        coord = mesh.get_coordinate()
        self.mesh, self.n_tokens = mesh, n_tokens
        self.experts = (0, n_experts)
        if m is not None:
            per = n_experts // mesh.size(m)
            self.experts = (coord[m] * per, (coord[m] + 1) * per)
        # the gathered counts come in this order of the token dimensions:
        # batch shards first (in mesh order, as Shard(0) lays them out),
        # then the windows of a shard: the order of the windows' starts
        self.order = bat + rep
        b = j = 0
        for i in bat:
            b = b * mesh.size(i) + coord[i]
        n_rep = 1
        for i in rep:
            j, n_rep = j * mesh.size(i) + coord[i], n_rep * mesh.size(i)
        self.window = (local_tokens * j // n_rep,
                       local_tokens * (j + 1) // n_rep)
        self.start = b * local_tokens + self.window[0]
        self.rank = b * n_rep + j

    def exchange(self, counts: torch.Tensor):
        """``(before, total)`` [E]: the pairs of each expert that the ranks
        whose windows come first hold, and that all ranks hold. Every rank
        along the token dimensions passes its own ``counts`` [E]."""
        c10d = torch.ops._c10d_functional
        t = counts
        for i in reversed(self.order):
            t = t[None]
            if self.mesh.size(i) > 1:
                group = self.mesh.get_group(i)
                t = c10d.wait_tensor(c10d.all_gather_into_tensor(
                    t, group.size(), group.group_name))
        table = t.reshape(-1, counts.shape[0])
        return table[:self.rank].sum(0), table.sum(0)


def moe_experts(fn, x, router, wi_gate, wi_up, wo, n_experts: int):
    """``fn(x, router, wi_gate, wi_up, wo, shard)`` (the MoE block's
    routing and experts) with x batch-sharded, the experts over ``'model'``
    and ``shard`` this rank's :class:`MoEShard` (None on a mesh of one
    device). Returns ``(y, aux)``: y batch-sharded, partial over the
    dimensions that split the experts or share the tokens; aux partial
    over the whole mesh."""
    mesh = x.device_mesh
    B, S = x.shape[0], x.shape[1]
    m = _model_dim(mesh, n_experts)
    every = range(mesh.ndim)
    bat = sorted(_batch_dims(mesh, B))
    rep = [i for i in every if i != m and i not in bat]
    xpl = _pl(mesh, {i: 0 for i in bat})
    ypl = _partial_over(mesh, xpl, [i for i in every if i not in bat])
    wpl = _pl(mesh, {m: 0} if m is not None else {})
    wgrad = _partial_over(mesh, wpl, [i for i in every if i != m])
    rep_pl = (Replicate(),) * mesh.ndim
    full = _partial_over(mesh, rep_pl, every)

    def local(xl, rl, wg, wu, wol):
        shard = None
        if mesh.size() > 1:
            shard = MoEShard(mesh, m, bat, rep, n_experts, B * S,
                             xl.shape[0] * xl.shape[1])
        return fn(xl, rl, wg, wu, wol, shard)
    return local_map(local, out_placements=(ypl, full),
                     in_placements=(xpl, rep_pl, wpl, wpl, wpl),
                     in_grad_placements=(ypl, full, wgrad, wgrad, wgrad),
                     redistribute_inputs=True)(x, router, wi_gate, wi_up, wo)


def cache_put(buf, upd, pos):
    """Write ``upd[:, 0]`` into the cache ``buf`` [B, Smax, ...] in place,
    row b at position ``pos[b]``, on the local shards. Without a host
    sync: a row whose position another rank's sequence shard holds
    writes back what its own shard holds there."""
    mesh = buf.device_mesh
    bpl = tuple(buf.placements)
    upl = tuple(Replicate() if p.is_shard(1) else p for p in bpl)
    rep = (Replicate(),) * mesh.ndim

    def local(bl, ul, p):
        coord = mesh.get_coordinate()
        b0 = s0 = 0
        for i, pl in enumerate(bpl):
            if pl.is_shard(0):
                b0 = b0 * mesh.size(i) + coord[i]
            if pl.is_shard(1):
                s0 = s0 * mesh.size(i) + coord[i]
        b0, s0 = b0 * bl.shape[0], s0 * bl.shape[1]
        lp = p[b0:b0 + bl.shape[0]] - s0
        inside = (lp >= 0) & (lp < bl.shape[1])
        lp = lp.clamp(0, bl.shape[1] - 1)
        rows = torch.arange(bl.shape[0], device=bl.device)
        new = torch.where(inside.view(-1, *[1] * (ul.dim() - 2)),
                          ul[:, 0], bl[rows, lp])
        return bl.index_put_((rows, lp), new)
    return local_map(local, out_placements=list(bpl),
                     in_placements=(bpl, upl, rep),
                     redistribute_inputs=True)(buf, upd, pos)
