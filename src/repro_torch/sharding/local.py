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
  are replicated over ``'model'`` with partial-sum gradients. A decode
  step's recurrences from a state (``ssm._ssd_chunked``,
  ``rwkv.wkv6_chunked``, plain torch) run the same way, the state placed
  as the heads.
* the Mamba block's in-projection and convolution (``ssm.ssd_block``):
  the projection's columns are z, x, B, C and Δ, whose boundaries do not
  fall on its ``'model'`` shards; one layer's projection and convolution
  weights are gathered, and each rank takes the columns of its heads' z,
  x and Δ and all of B and C (one group, which every head reads), so that
  z, x and Δ come out of the product sharded by heads.
* the embedding lookup (``rules.embed_rows``): the table's vocabulary
  rows stay over ``'model'`` and only its FSDP shard is gathered; each
  rank looks up the ids that fall in its rows, the others read as zero,
  and the partial rows are summed over ``'model'`` where the activation
  is placed. The table's gradient is a partial sum over the batch
  dimensions, scattered back to its shard.
* the head (``rules.unembed``): the tokens over the batch dimensions, the
  vocabulary over ``'model'``, so that no rank holds a whole row of
  logits; the gradient of h is a partial sum over ``'model'``, that of
  the unembedding over the batch dimensions.
* the loss (``lm.token_nll``): vocabulary-parallel, as Megatron's cross
  entropy: the log-sum-exp and the label's logit are reduced over
  ``'model'`` by all-reduces of one number a token, and the backward,
  softmax minus the label's one-hot, is local.
* the one-token attention over a decode cache (``layers.decode_attention``):
  where the cache holds it, batch over its dimensions and, over
  ``'model'``, the heads (local), the head features (the scores summed
  over ``'model'``) or the sequence (the softmax's max and sum and the
  output reduced over ``'model'``).
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

import functools

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .rules import _data_axes, _div, axis_size

__all__ = ["rmsnorm", "attention", "ssd_scan", "wkv6", "moe_experts",
           "MoEShard", "cache_put", "embed", "head", "token_nll", "ssd_in",
           "decode_attention"]


def _replicated(x, mesh):
    """``x``, a DTensor: a plain tensor (the same on every rank) becomes a
    replicated one on ``mesh``."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


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


def ssd_scan(fn, xh, dt, A, Bm, Cm, chunk: int, state=None):
    """``fn(xh, dt, A, Bm, Cm, chunk=chunk)`` with batch and heads local;
    with a ``state`` [B, H, P, N] (a decode step), ``fn(..., h0=state)``,
    which returns ``(y, new state)``, both placed as the heads."""
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
    if state is not None:
        spl = _pl(mesh, {**bat, **({m: 1} if m is not None else {})})
        return local_map(lambda *a: fn(*a[:5], chunk=chunk, h0=a[5]),
                         out_placements=(xpl, spl),
                         in_placements=(xpl, xpl, apl, bpl, bpl, spl),
                         in_grad_placements=(xpl, xpl, agrad, bgrad, bgrad,
                                             spl),
                         redistribute_inputs=True)(xh, dt, A, Bm, Cm, state)
    return local_map(lambda *a: fn(*a, chunk=chunk), out_placements=list(xpl),
                     in_placements=(xpl, xpl, apl, bpl, bpl),
                     in_grad_placements=(xpl, xpl, agrad, bgrad, bgrad),
                     redistribute_inputs=True)(xh, dt, A, Bm, Cm)


def wkv6(fn, r, k, v, lw, u, chunk: int, state=None):
    """``fn(r, k, v, lw, u, chunk=chunk)`` with batch and heads local; with
    a ``state`` [B, H, P, P] (a decode step), ``fn(..., s0=state)``, which
    returns ``(y, new state)``, both placed as the heads."""
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
    if state is not None:
        spl = _pl(mesh, {**{i: 0 for i in bat},
                         **({m: 1} if m is not None else {})})
        return local_map(lambda *a: fn(*a[:5], chunk=chunk, s0=a[5]),
                         out_placements=(xpl, spl),
                         in_placements=(xpl, xpl, xpl, xpl, upl, spl),
                         in_grad_placements=(xpl, xpl, xpl, xpl, ugrad, spl),
                         redistribute_inputs=True)(r, k, v, lw, u, state)
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


def embed(table, ids):
    """``table[ids]``, vocabulary-parallel, batch-sharded like ``ids`` and
    replicated over ``'model'``: the table's rows stay over the mesh
    dimensions that shard them (``'model'``), and each rank looks up the
    ids in its rows, the others reading as zero. Two ways of meeting the
    table's FSDP shard of columns (over ``'data'``): where the table takes
    a gradient, or the ids outnumber the rank's rows, it is gathered, and
    the lookup's partial rows are summed over ``'model'`` (the table's
    gradient comes back a partial sum over the batch dimensions, scattered
    to its shard); else (a decode step) the ids of the ``'data'`` group
    are gathered instead, each rank looks up its columns of all of them,
    and an all-to-all over ``'data'`` hands each rank its own rows."""
    mesh = table.device_mesh
    ids = _replicated(ids, mesh)
    names = mesh.mesh_dim_names
    rows = [i for i, p in enumerate(table.placements)
            if p.is_shard(0) and mesh.size(i) > 1
            and names[i] not in ("pod", "data")]
    cols = [i for i, p in enumerate(table.placements)
            if p.is_shard(1) and mesh.size(i) > 1]
    bat = _batch_dims(mesh, ids.shape[0])
    ipl = _pl(mesh, {i: 0 for i in bat})
    n_rows = table.shape[0]
    for i in rows:
        n_rows //= mesh.size(i)
    if not table.requires_grad and ids.numel() < n_rows \
            and len(cols) == 1 and cols[0] in bat:
        return _embed_columns(table, ids, rows, cols[0], bat, ipl)
    tpl = _pl(mesh, {i: 0 for i in rows})
    tgrad = _partial_over(mesh, tpl, bat)

    def local(tl, il):
        return _lookup(tl, il, _offset(mesh, rows, tl.shape[0]))
    out = local_map(local, out_placements=list(_partial_over(mesh, ipl,
                                                             rows)),
                    in_placements=(tpl, ipl), in_grad_placements=(tgrad, ipl),
                    redistribute_inputs=True)(table, ids)
    return out.redistribute(mesh, ipl) if rows else out


def _offset(mesh, dims, size: int) -> int:
    """Where this rank's shard of ``size`` begins along the mesh
    dimensions ``dims`` (outer first)."""
    lo = 0
    for i in dims:
        lo = lo * mesh.size(i) + mesh.get_local_rank(i)
    return lo * size


def _lookup(tl, il, lo: int):
    """The rows ``il - lo`` of the local rows ``tl``; ids outside them read
    as zero."""
    j = il - lo
    inside = (j >= 0) & (j < tl.shape[0])
    out = torch.nn.functional.embedding(j.clamp(0, tl.shape[0] - 1), tl)
    return out * inside[..., None].to(out.dtype)


def _embed_columns(table, ids, rows, c: int, bat, ipl):
    """:func:`embed` without gathering the table: the ids gathered over
    the mesh dimension ``c`` that shards the table's columns, each rank's
    columns of all their rows summed over ``rows``, then an all-to-all
    over ``c`` from [rows of the group, S, own columns] to [own rows, S,
    every column]. No gradient flows (``embed`` takes this way only for a
    table without one)."""
    mesh = table.device_mesh
    c10d = torch.ops._c10d_functional
    gpl = _pl(mesh, {i: 0 for i in bat if i != c})
    n = mesh.size(c)
    group = mesh.get_group(c)

    def local(tl, il):
        out = _lookup(tl, il, _offset(mesh, rows, tl.shape[0]))
        for i in rows:
            out = _all_reduce(out, "sum", mesh.get_group(i))
        split = [out.shape[0] // n] * n
        out = c10d.wait_tensor(c10d.all_to_all_single(
            out.contiguous(), split, split, group.group_name))
        out = out.reshape(n, -1, *out.shape[1:]).movedim(0, -2)
        return out.reshape(*out.shape[:-2], -1)
    return local_map(local, out_placements=list(ipl),
                     in_placements=(table.placements, gpl),
                     in_grad_placements=(table.placements, gpl),
                     redistribute_inputs=True)(table, ids)


def head(h, w):
    """``h @ w``: h [B, S, D] over the batch dimensions, w [D, V] over
    ``'model'`` by its columns (where V divides it) and gathered over the
    others; the logits over the batch dimensions and the vocabulary."""
    mesh = h.device_mesh
    bat = _batch_dims(mesh, h.shape[0])
    m = _model_dim(mesh, w.shape[-1])
    voc = {m: 1} if m is not None else {}
    hpl = _pl(mesh, {i: 0 for i in bat})
    wpl = _pl(mesh, voc)
    opl = _pl(mesh, {**{i: 0 for i in bat},
                     **({m: h.dim() - 1} if m is not None else {})})
    hgrad = _partial_over(mesh, hpl, list(voc))
    wgrad = _partial_over(mesh, wpl, bat)
    return local_map(torch.matmul, out_placements=list(opl),
                     in_placements=(hpl, wpl),
                     in_grad_placements=(hgrad, wgrad),
                     redistribute_inputs=True)(h, w)


def _all_reduce(t, op: str, group):
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_reduce(t, op, group.group_name))


class _VocabNLL(torch.autograd.Function):
    """``-log softmax(z)[label]`` of a shard of the vocabulary: ``z`` the
    f32 logits of columns [lo, lo + V_l) with the padding past ``vocab``
    masked, reduced over ``group``. Saves ``exp(z - max)`` and its sum;
    the backward needs no collective."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, vocab: int, group):
        iota = torch.arange(lo, lo + logits.shape[-1], device=logits.device)
        z = logits + torch.where(iota < vocab, 0.0, -1e30)
        m = _all_reduce(z.amax(dim=-1, keepdim=True), "max", group)
        e = torch.exp(z - m)
        s = _all_reduce(e.sum(dim=-1, keepdim=True), "sum", group)
        j = labels[..., None] - lo
        inside = (j >= 0) & (j < z.shape[-1])
        picked = torch.gather(z, -1, j.clamp(0, z.shape[-1] - 1))
        picked = _all_reduce(torch.where(inside, picked, 0.0), "sum", group)
        ctx.save_for_backward(e, s, labels)
        ctx.lo = lo
        return torch.log(s) + m - picked

    @staticmethod
    def backward(ctx, g):
        e, s, labels = ctx.saved_tensors
        iota = torch.arange(ctx.lo, ctx.lo + e.shape[-1], device=e.device)
        dz = (e / s).sub_((iota == labels[..., None]).to(e.dtype)).mul_(g)
        return dz, None, None, None, None


def token_nll(logits, labels, vocab: int):
    """The NLL of each token, [..., 1], of f32 ``logits`` whose last
    dimension is sharded over ``'model'``: batch-sharded like ``labels``,
    replicated over ``'model'``."""
    mesh = logits.device_mesh
    labels = _replicated(labels, mesh)
    last = logits.dim() - 1
    bat = _batch_dims(mesh, logits.shape[0])
    m = _model_dim(mesh, logits.shape[-1])
    lpl = _pl(mesh, {**{i: 0 for i in bat}, m: last})
    ypl = _pl(mesh, {i: 0 for i in bat})
    group = mesh.get_group(m)

    def local(zl, yl):
        lo = mesh.get_local_rank(m) * zl.shape[-1]
        return _VocabNLL.apply(zl, yl, lo, vocab, group)
    return local_map(local, out_placements=list(ypl),
                     in_placements=(lpl, ypl), in_grad_placements=(lpl, ypl),
                     redistribute_inputs=True)(logits, labels)


class _GradScale(torch.autograd.Function):
    """The identity, whose backward scales the gradient by ``scale``: each
    rank runs the same graph, and only one of them passes a gradient on."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def ssd_in(fn, x, w, conv_w, conv_b, d_inner: int, n_state: int,
           n_heads: int):
    """``fn(x, w, conv_w, conv_b, cols, conv_cols)`` (the Mamba block's
    in-projection and convolution of the columns ``cols`` of ``w`` and
    ``conv_cols`` of the convolution) with the batch over its dimensions
    and the heads over ``'model'``: returns ``(z, x, B, C, Δ)``, z, x and
    Δ sharded by heads, B and C replicated over ``'model'``. The ranks
    but the first of ``'model'`` compute B and C without a gradient, so
    that their gradients, partial sums over ``'model'``, count once."""
    mesh = x.device_mesh
    m = _model_dim(mesh, n_heads)
    bat = _batch_dims(mesh, x.shape[0])
    n = mesh.size(m)
    dl, hl = d_inner // n, n_heads // n
    last = x.dim() - 1
    xpl = _pl(mesh, {i: 0 for i in bat})
    hpl = _pl(mesh, {**{i: 0 for i in bat}, m: last})
    rep = (Replicate(),) * mesh.ndim
    split = [*bat, m]
    wgrad = _partial_over(mesh, rep, split)
    xgrad = _partial_over(mesh, xpl, [m])

    def local(xl, wl, cwl, cbl):
        r = mesh.get_local_rank(m)
        ar = functools.partial(torch.arange, device=wl.device)
        heads = torch.cat([ar(r * dl, (r + 1) * dl),
                           ar(d_inner + r * dl, d_inner + (r + 1) * dl),
                           ar(2 * d_inner, 2 * d_inner + 2 * n_state),
                           ar(2 * (d_inner + n_state) + r * hl,
                              2 * (d_inner + n_state) + (r + 1) * hl)])
        conv = torch.cat([ar(r * dl, (r + 1) * dl),
                          ar(d_inner, d_inner + 2 * n_state)])
        z, xs, bm, cm, dt = fn(xl, wl, cwl, cbl, heads, conv)
        keep = 1.0 if r == 0 else 0.0
        return z, xs, _GradScale.apply(bm, keep), _GradScale.apply(cm, keep), dt
    return local_map(local, out_placements=(hpl, hpl, xpl, xpl, hpl),
                     in_placements=(xpl, rep, rep, rep),
                     in_grad_placements=(xgrad, wgrad, wgrad, wgrad),
                     redistribute_inputs=True)(x, w, conv_w, conv_b)


def decode_attention(q, k, v, cache_len, neg_inf: float):
    """One token a row against a [B, S, Hkv, Dh] cache placed by the cache
    rules: ``layers.decode_attention`` on the local shards, q placed as
    the cache's heads or head features, the output sharded by heads where
    the cache is, else replicated over ``'model'``."""
    mesh = k.device_mesh
    cpl = tuple(k.placements)
    names = list(mesh.mesh_dim_names)
    m = names.index("model") if "model" in names else None
    dim = None
    if m is not None and mesh.size(m) > 1 and cpl[m].is_shard():
        dim = cpl[m].dim            # 2 heads, 3 features, 1 sequence
    bat = [i for i, p in enumerate(cpl) if p.is_shard(0)]
    qpl = _pl(mesh, {**{i: 0 for i in bat},
                     **({m: dim} if dim in (2, 3) else {})})
    lpl = _pl(mesh, {i: 0 for i in bat})
    if not isinstance(cache_len, DTensor):
        lens = torch.as_tensor(cache_len, device=k.to_local().device)
        cache_len = _replicated(lens.reshape(-1).expand(k.shape[0]), mesh)
    group = mesh.get_group(m) if dim in (1, 3) else None
    scale = 1.0 / q.shape[-1] ** 0.5

    def local(ql, kl, vl, ll):
        B, Sq, Hq, Dh = ql.shape
        Sl, Hkv = kl.shape[1], kl.shape[2]
        qg = ql.reshape(B, Sq, Hkv, Hq // Hkv, Dh)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kl)
        if dim == 3:
            s = _all_reduce(s, "sum", group)
        lo = mesh.get_local_rank(m) * Sl if dim == 1 else 0
        pos = torch.arange(lo, lo + Sl, device=kl.device)
        mask = pos[None, :] < ll.reshape(-1, 1)
        s = (s * scale).float().masked_fill(~mask[:, None, None, None, :],
                                            neg_inf)
        if dim == 1:
            mx = _all_reduce(s.amax(dim=-1, keepdim=True), "max", group)
            e = torch.exp(s - mx)
            den = _all_reduce(e.sum(dim=-1, keepdim=True), "sum", group)
            o = _all_reduce(torch.einsum("bhgqk,bkhd->bhgqd", e,
                                         vl.float()), "sum", group) / den
        else:
            o = torch.einsum("bhgqk,bkhd->bhgqd", torch.softmax(s, dim=-1),
                             vl.float())
        return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(ql.dtype)
    o = local_map(local, out_placements=list(qpl),
                  in_placements=(qpl, cpl, cpl, lpl),
                  in_grad_placements=(qpl, cpl, cpl, lpl),
                  redistribute_inputs=True)(q, k, v, cache_len)
    # the features gathered (one token a row): merged with the heads,
    # a sharded inner dimension would be a strided shard
    return o.redistribute(mesh, lpl) if dim == 3 else o
