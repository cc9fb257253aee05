"""TASKGRAPH intermediate representation (paper §4).

A TASKGRAPH is a dataflow DAG describing a multi-device computation:

* vertices are operations over tensors — either graph *inputs* (weights /
  activations, resident in the host store before execution), *compute* kernel
  calls bound to a specific device, device-to-device *transfers*, or n-ary
  commutative *reductions* (which may be lowered to streaming ``sum-into``
  groups per paper §B);
* edges represent data flow (``TaskVertex.inputs``).

TURNIP is agnostic about how the TASKGRAPH is produced (paper: FlexFlow /
Alpa); in this repo :mod:`repro_torch.core.trace` builds them from model configs by
decomposing layer compute into sliced matmul fragments (paper Fig. 2/3).

Sizes are expressed in abstract *units* via a caller-supplied ``size_fn`` so
the same machinery serves the paper's uniform-slot presentation (Fig. 8:
``size_fn = lambda v: 1``) and the byte-granular "real life" variant (§6).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Iterable

import numpy as np
import torch

__all__ = ["OpKind", "TensorSpec", "TaskVertex", "TaskGraph", "GraphValidationError"]


class GraphValidationError(ValueError):
    """Raised when a TASKGRAPH violates a structural invariant."""


class OpKind(str, enum.Enum):
    INPUT = "input"        # graph input; lives in the host store pre-execution
    COMPUTE = "compute"    # kernel call on a specific device
    TRANSFER = "transfer"  # device-to-device copy (output lives on `device`)
    REDUCE = "reduce"      # n-ary commutative reduction (may stream, paper §B)


_DTYPE_BYTES = {
    "float32": 4, "bfloat16": 2, "float16": 2, "int32": 4, "int8": 1,
    "uint8": 1, "bool": 1, "float64": 8, "int64": 8,
}
_TORCH_DTYPE = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "int32": torch.int32, "int8": torch.int8,
    "uint8": torch.uint8, "bool": torch.bool, "float64": torch.float64,
    "int64": torch.int64,
}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape/dtype descriptor for a vertex output (no data)."""

    shape: tuple[int, ...]
    dtype: str = "float32"

    def __post_init__(self) -> None:
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        if self.dtype not in _DTYPE_BYTES:
            raise GraphValidationError(f"unknown dtype {self.dtype!r}")

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def nbytes(self) -> int:
        return self.size * _DTYPE_BYTES[self.dtype]

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPE[self.dtype]


@dataclasses.dataclass
class TaskVertex:
    """One operation in a TASKGRAPH."""

    tid: int
    kind: OpKind
    device: int
    inputs: tuple[int, ...]
    out: TensorSpec
    op: str = ""                 # op-registry name used by the runtime
    params: dict[str, Any] = dataclasses.field(default_factory=dict)
    flops: float = 0.0           # estimate for the simulator / roofline
    name: str = ""
    streaming: bool = False      # REDUCE only: lower to sum-into group (§B)

    def __post_init__(self) -> None:
        self.inputs = tuple(self.inputs)


class TaskGraph:
    """A dataflow DAG of :class:`TaskVertex`."""

    def __init__(self) -> None:
        self.vertices: dict[int, TaskVertex] = {}
        self._consumers: dict[int, list[int]] = {}
        self._next_tid = 0

    # -- construction -----------------------------------------------------
    def add(
        self,
        kind: OpKind | str,
        device: int,
        inputs: Iterable[int] = (),
        out: TensorSpec | tuple = (1,),
        *,
        op: str = "",
        params: dict | None = None,
        flops: float = 0.0,
        name: str = "",
        streaming: bool = False,
    ) -> int:
        kind = OpKind(kind)
        if not isinstance(out, TensorSpec):
            out = TensorSpec(tuple(out))
        tid = self._next_tid
        self._next_tid += 1
        inputs = tuple(inputs)
        for i in inputs:
            if i not in self.vertices:
                raise GraphValidationError(f"vertex {tid}: unknown input {i}")
        if kind == OpKind.INPUT and inputs:
            raise GraphValidationError("INPUT vertices take no inputs")
        if kind != OpKind.INPUT and not inputs:
            raise GraphValidationError(f"{kind} vertex {tid} needs inputs")
        v = TaskVertex(tid, kind, device, inputs, out, op=op,
                       params=dict(params or {}), flops=flops, name=name,
                       streaming=streaming)
        self.vertices[tid] = v
        self._consumers[tid] = []
        for i in inputs:
            self._consumers[i].append(tid)
        return tid

    # convenience wrappers
    def add_input(self, device: int, out, *, name: str = "", op: str = "input",
                  params: dict | None = None) -> int:
        return self.add(OpKind.INPUT, device, (), out, op=op, name=name, params=params)

    def add_compute(self, device: int, inputs, out, *, op: str, flops: float = 0.0,
                    params: dict | None = None, name: str = "") -> int:
        return self.add(OpKind.COMPUTE, device, inputs, out, op=op, flops=flops,
                        params=params, name=name)

    def add_transfer(self, device: int, src: int, *, name: str = "") -> int:
        spec = self.vertices[src].out
        return self.add(OpKind.TRANSFER, device, (src,), spec, op="copy", name=name)

    def add_reduce(self, device: int, inputs, out=None, *, streaming: bool = True,
                   op: str = "sum", name: str = "") -> int:
        inputs = tuple(inputs)
        spec = out if out is not None else self.vertices[inputs[0]].out
        return self.add(OpKind.REDUCE, device, inputs, spec, op=op, name=name,
                        streaming=streaming)

    # -- queries -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.vertices)

    def consumers(self, tid: int) -> tuple[int, ...]:
        return tuple(self._consumers[tid])

    def devices(self) -> tuple[int, ...]:
        return tuple(sorted({v.device for v in self.vertices.values()}))

    def topo_order(self) -> list[int]:
        """Kahn topo sort; raises on cycles. Insertion order is a valid topo
        order by construction (inputs must exist), but we re-derive it for
        validation and to support graph surgery."""
        indeg = {t: len(set(v.inputs)) for t, v in self.vertices.items()}
        ready = [t for t, d in indeg.items() if d == 0]
        order: list[int] = []
        while ready:
            t = ready.pop()
            order.append(t)
            for c in set(self._consumers[t]):
                uses = sum(1 for i in self.vertices[c].inputs if i == t)
                del uses  # duplicate inputs count once in indeg
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(self.vertices):
            raise GraphValidationError("TASKGRAPH contains a cycle")
        return order

    def validate(self) -> None:
        self.topo_order()
        for v in self.vertices.values():
            if v.kind == OpKind.TRANSFER:
                src = self.vertices[v.inputs[0]]
                if src.device == v.device:
                    raise GraphValidationError(
                        f"transfer {v.tid} is a same-device copy ({v.device})")

    def total_flops(self) -> float:
        return sum(v.flops for v in self.vertices.values())

    def total_bytes(self, size_fn: Callable[[TaskVertex], int] | None = None) -> int:
        size_fn = size_fn or (lambda v: v.out.nbytes)
        return sum(size_fn(v) for v in self.vertices.values())

    def stats(self) -> dict[str, Any]:
        kinds: dict[str, int] = {}
        for v in self.vertices.values():
            kinds[v.kind.value] = kinds.get(v.kind.value, 0) + 1
        return {
            "n_vertices": len(self),
            "by_kind": kinds,
            "devices": self.devices(),
            "flops": self.total_flops(),
            "out_bytes": self.total_bytes(),
        }
