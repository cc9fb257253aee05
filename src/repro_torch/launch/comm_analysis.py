"""Collective traffic of a traced step: the port's counterpart of the
reference's ``launch/hlo_analysis.py``.

The reference parses XLA's optimized HLO and sums the *result* bytes of
every collective instruction, multiplying those inside ``while`` bodies
by the loop's trip count (its layers are a scan). The port has no HLO: its
step runs eagerly on DTensors, so :class:`CommCounter`, a
``CommDebugMode``, sees each collective as it is issued and adds its
result bytes by kind (all-gather, all-reduce, reduce-scatter, all-to-all).
Eager tracing unrolls every layer, so there are no trip counts to fold.
It is the reference's model of traffic, not a measurement: an all-reduce
is counted once (a ring moves about 2 (N-1)/N times its bytes), an
all-gather or a reduce-scatter by its result.

A process group on CPU tensors has no all-to-all: DTensor falls back to an
all-gather and a chunk there (its warning). On shape-only tensors,
:func:`asked_collectives` sends DTensor's all-to-all to its own operator
(which has a meta implementation), so that what is counted is what the
step asks for, not what the fallback would send.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
from torch.distributed.tensor.debug import CommDebugMode

__all__ = ["CommCounter", "asked_collectives", "KINDS"]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


def _kind(func) -> str | None:
    name = func._overloadpacket.__name__
    if "all_gather" in name or "allgather" in name:
        return "all-gather"
    if "reduce_scatter" in name:
        return "reduce-scatter"
    if "all_reduce" in name or "allreduce" in name:
        return "all-reduce"
    if "all_to_all" in name or "alltoall" in name:
        return "all-to-all"
    return None


def _nbytes(out) -> int:
    outs = out if isinstance(out, (list, tuple)) else (out,)
    return sum(t.numel() * t.element_size() for t in outs
               if isinstance(t, torch.Tensor))


class CommCounter(CommDebugMode):
    """``CommDebugMode`` that also sums each collective's result bytes by
    kind: :meth:`record` gives the reference's ``collectives`` entry,
    ``{"by_kind": {kind: bytes}, "counts": {kind: n}, "total_bytes"}``."""

    def __init__(self) -> None:
        super().__init__()
        self.by_kind: dict[str, list[int]] = defaultdict(lambda: [0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(
                func, torch._ops.HigherOrderOperator):
            return out
        pkt = func._overloadpacket
        if pkt in self.comm_registry:
            kind = _kind(func)
            if kind is not None:
                self.by_kind[kind][0] += 1
                self.by_kind[kind][1] += _nbytes(out)
        return out

    def record(self) -> dict:
        kinds = sorted(self.by_kind)
        return {"by_kind": {k: self.by_kind[k][1] for k in kinds},
                "counts": {k: self.by_kind[k][0] for k in kinds},
                "total_bytes": sum(b for _, b in self.by_kind.values())}


@contextlib.contextmanager
def asked_collectives():
    """DTensor's shard-to-shard redistribution issues its all-to-all
    operator on shape-only tensors, where a CPU process group would fall
    back to an all-gather."""
    from torch.distributed.tensor import placement_types

    orig = getattr(placement_types, "shard_dim_alltoall", None)
    if orig is None or not hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        yield                   # a torch without DTensor's all-to-all op
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if input.device.type != "meta":
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig
