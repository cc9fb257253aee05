"""Dry run: the port of ``repro/launch/dryrun.py``, on meta tensors.

For every (architecture x input shape) cell, trace the sharded step (the
training step with AdamW as ``make_train_step`` builds it for ``train``
shapes, ``apply`` for ``prefill``, ``decode_step`` over ``init_cache``
for ``decode``) on one rank of the production mesh and record what one
device would hold and do. This is the port's one entry point that needs no
card, the counterpart of the reference's 512 placeholder devices: one
process joins a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``), builds the mesh with a
CPU device type (so nothing touches CUDA state, on a machine with a card
too), and runs the step on DTensors whose local shards are meta tensors,
placed by the sharding rules (``sharding/rules.py``). Nothing is allocated
on any device, and no process group outlives :func:`lower_cell`.

The record has the reference's keys (``dryrun.py:149-182``):

* ``memory``: ``argument_bytes``, the rank's local shards of state and
  batch; ``temp_bytes``, the peak of live storage bytes during the step
  beyond the arguments (:class:`StepTracker`, which sees every local
  allocation, the collectives' buffers included); ``output_bytes``, the
  step's outputs; ``alias_bytes``, in training the new state that could
  take the old one's place (the reference donates it; the port's step
  keeps the old state until it returns, so this does not lower the
  peak); ``host_temp_bytes``, the bytes ``remat='offload'`` moves to
  pinned host memory; ``peak_bytes_per_device`` = argument + temp. With
  ``top_live`` (``--top-live N``), also ``top_live``: the N largest
  storages live at the peak, each with its shape, dtype, bytes and the
  aten op that made it (``"argument"`` for the step's inputs).
* ``cost``: ``flops``, the products' operations counted from the aten ops
  (``torch.utils.flop_counter``'s formulas, on local shapes) plus each
  hand-written kernel's own count (``flash_ops``, the backward's five
  products, ``gmm_cost``, ``ssd_ops``, ``wkv6_ops``, rmsnorm's), which
  the kernels' wrappers report on shape-only tensors
  (``kernels/shape_only.py``); ``bytes_accessed``, each aten op's local
  inputs and outputs once plus the kernels' own bytes. In place of the
  reference's ``xla_raw_flops`` and ``xla_raw_bytes`` (XLA's own counts),
  ``aten_flops`` and ``aten_bytes`` (the aten ops alone) and ``kernels``
  (calls, operations and bytes by kernel).
* ``collectives``: result bytes by kind (``comm_analysis.py``).
* ``model``: ``params`` and ``active_params``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape train_4k [--multipod] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-7b \
        --shape prefill_32k --top-live 5      # what the peak holds
"""
from __future__ import annotations

import argparse
import contextlib
import heapq
import json
import pathlib
import time
import traceback
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import (ASSIGNED, SHAPES, ArchConfig, ShapeConfig,
                       applicable_shapes, get_arch, input_specs)
from ..kernels.shape_only import recording
from ..models import build_model
from ..sharding.rules import (batch_spec, cache_spec, param_spec,
                              shard_tree, state_spec, use_mesh)
from ..train.optim import AdamW
from ..train.step import make_train_step
from .comm_analysis import CommCounter, asked_collectives

__all__ = ["lower_cell", "fake_mesh", "StepTracker", "main"]


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


class StepTracker(TorchDispatchMode):
    """Live storage bytes, products' operations and bytes moved of the
    aten ops a step runs. An op on DTensors is left to DTensor (the mode
    returns ``NotImplemented``, as ``CommDebugMode`` does), so the mode
    sees the local ops it runs, collectives included, with local shapes.
    The fake-tensor ops DTensor runs to propagate shapes are not counted.
    With ``top`` > 0 it also keeps ``top_live``, the ``top`` largest
    storages live at the peak: (op, shape, dtype, bytes)."""

    def __init__(self, top: int = 0) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.top = top
        self.top_live: list[tuple] = []
        self._seen: dict[int, weakref.ref] = {}
        self._what: dict[int, tuple] = {}

    def track(self, t: torch.Tensor, exact: bool = False,
              op: str = "argument") -> None:
        """Count ``t``'s storage as live until it is freed (``exact``: only
        ``t``'s own bytes of it); ``op`` made it."""
        st = _local(t).untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = t.numel() * t.element_size() if exact else st.nbytes()

        def freed(_, key=key, n=n):
            self._seen.pop(key, None)
            self._what.pop(key, None)
            self.live -= n
        self._seen[key] = weakref.ref(st, freed)
        self.live += n
        if self.top:
            self._what[key] = (op, tuple(_local(t).shape),
                               str(t.dtype).replace("torch.", ""), n)
        if self.live > self.peak:
            self.peak = self.live
            if self.top:
                self.top_live = heapq.nlargest(self.top, self._what.values(),
                                               key=lambda w: w[3])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in outs):
            return out          # DTensor's shape propagation, not the step
        pkt = func._overloadpacket
        if pkt in flop_registry:
            self.flops += int(flop_registry[pkt](*args, **kwargs,
                                                 out_val=out))
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        # the all-to-all's meta implementation returns a chunk of a
        # gathered buffer; the card's collective writes the chunk alone
        exact = pkt is torch.ops._dtensor.shard_dim_alltoall
        for t in outs:
            self.track(t, exact, str(func) if self.top else "")
        return out


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over a fake process group of its size,
    as rank 0, with a CPU device type; the group is destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def _mesh_axes(multi_pod: bool, mesh_shape) -> tuple[tuple, tuple]:
    """The production mesh's shape and axis names
    (``launch/mesh.py::make_production_mesh``)."""
    shape = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    if multi_pod and len(shape) == 2:
        shape = (2, *shape)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} does not match axes {names}")
    return tuple(shape), names


def _nbytes(tree) -> int:
    seen, n = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = _local(t).untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                n += st.nbytes()
    return n


def _draw(gen: torch.Generator, like: torch.Tensor, vocab: int, device):
    """A real tensor shaped like the meta input ``like``: token ids uniform
    over the vocabulary, embeddings N(0, 1), scalars 0."""
    if like.dim() == 0:
        return torch.zeros((), dtype=like.dtype, device=device)
    if like.is_floating_point():
        t = torch.randn(like.shape, generator=gen, dtype=like.dtype,
                        device=gen.device)
    else:
        t = torch.randint(0, vocab, like.shape, generator=gen,
                          dtype=like.dtype, device=gen.device)
    return t.to(device)


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
               remat: str | None = "full", kv_cache_dtype: str = "bf16",
               device="meta", gen: torch.Generator | None = None):
    """``(step, args, model)`` of one cell on ``mesh``: the model on
    ``device``, its state and batch sharded by the rules, and
    ``step(*args)`` the step to run under ``use_mesh(mesh)``. On a real
    device the parameters, the tokens (uniform over the vocabulary), the
    frontends' embeddings and the decode cache are drawn from ``gen``;
    meta draws nothing. The smoke builds the same cells on the card."""
    kw = {}
    if cfg.family in ("dense", "moe"):
        kw["kv_cache_dtype"] = kv_cache_dtype
    model = build_model(cfg, remat=remat if shape.kind == "train" else None,
                        device=device, **kw)
    gen = gen or torch.Generator()
    specs = input_specs(cfg, shape)
    if device != "meta":
        specs = {k: _draw(gen, v, cfg.vocab_size, model.device)
                 for k, v in specs.items()}
    if shape.kind == "train":
        opt = AdamW()
        params = model.init(gen)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=params["embed"].device)}
        state = shard_tree(state, state_spec(state, mesh), mesh)
        batch = shard_tree(specs, batch_spec(specs, mesh), mesh)
        return make_train_step(model, opt), (state, batch), model
    params = model.init(gen)
    params = shard_tree(params, param_spec(params, mesh), mesh)
    if shape.kind == "prefill":
        batch = shard_tree(specs, batch_spec(specs, mesh), mesh)

        def prefill(params, batch):
            extra = {k: v for k, v in batch.items() if k != "tokens"}
            return model.apply(params, batch["tokens"], **extra)
        return prefill, (params, batch), model
    B, S = shape.global_batch, shape.seq_len
    cache = (model.init_cache(B, S, S) if cfg.family == "encdec"
             else model.init_cache(B, S))
    if device != "meta":
        for t in cache.values():
            if not t.is_floating_point():
                continue
            if t.device == gen.device:
                t.normal_(generator=gen)        # in place: no temporary
            else:
                t.copy_(torch.randn(t.shape, generator=gen, dtype=t.dtype,
                                    device=gen.device))
    cache = shard_tree(cache, cache_spec(cache, mesh), mesh)
    token = {"token": specs["token"]}
    token = shard_tree(token, batch_spec(token, mesh), mesh)["token"]

    def serve_step(params, cache, token):
        return model.decode_step(params, cache, token, S - 1)
    return serve_step, (params, cache, token), model


def trace_step(step, args, top_live: int = 0) -> dict:
    """Run ``step(*args)`` under the trackers; the memory, cost and
    collectives entries of a record (with ``top_live``, the largest
    storages live at the peak)."""
    from ..models import offload
    tracker = StepTracker(top_live)
    kernels: dict[str, list[int]] = defaultdict(lambda: [0, 0, 0])

    def on_kernel(name, ops, nbytes):
        k = kernels[name]
        k[0], k[1], k[2] = k[0] + 1, k[1] + ops, k[2] + nbytes
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor):
            tracker.track(t)
    arg_bytes = tracker.live
    tracker.peak = tracker.live
    offload.reset_moved()
    with CommCounter() as comm, asked_collectives(), recording(on_kernel), \
            tracker:
        out = step(*args)
    out_bytes = _nbytes(out)
    alias = 0
    if isinstance(out, tuple) and isinstance(out[0], dict) \
            and "opt" in out[0]:                    # (state, metrics)
        alias = min(_nbytes(out[0]), _nbytes(args[0]))
    temp = tracker.peak - arg_bytes
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": temp, "alias_bytes": alias,
              "host_temp_bytes": offload.moved["offloaded"],
              "peak_bytes_per_device": arg_bytes + temp}
    if top_live:
        memory["top_live"] = [{"op": op, "shape": list(shape),
                               "dtype": dtype, "bytes": n}
                              for op, shape, dtype, n in tracker.top_live]
    return {
        "memory": memory,
        "cost": {"flops": tracker.flops + sum(k[1] for k in
                                              kernels.values()),
                 "bytes_accessed": tracker.bytes + sum(k[2] for k in
                                                       kernels.values()),
                 "aten_flops": tracker.flops, "aten_bytes": tracker.bytes,
                 "kernels": {n: {"calls": c, "ops": o, "bytes": b}
                             for n, (c, o, b) in sorted(kernels.items())}},
        "collectives": comm.record(),
    }, out


def lower_cell(arch: str | ArchConfig, shape: str | ShapeConfig, *,
               multi_pod: bool = False, remat: str | None = "full",
               block_kv: int = 1024, kv_cache_dtype: str = "bf16",
               extra_tag: str = "",
               mesh_shape: tuple[int, ...] | None = None,
               top_live: int = 0) -> dict:
    """Trace one (arch x shape) cell on one rank of the production mesh
    (or ``mesh_shape``); returns the record. ``arch`` and ``shape`` are
    names or configs. ``block_kv`` is the reference's XLA block size: the
    flash kernel keeps its own tiles, so it is recorded and not used.
    ``top_live`` > 0 adds ``memory.top_live``."""
    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch)
    shp = shape if isinstance(shape, ShapeConfig) else SHAPES[shape]
    dims, names = _mesh_axes(multi_pod, mesh_shape)
    t0 = time.perf_counter()
    with fake_mesh(dims, names) as mesh:
        step, args, _ = build_cell(cfg, shp, mesh, remat=remat,
                                   kv_cache_dtype=kv_cache_dtype)
        with use_mesh(mesh):
            rec, _ = trace_step(step, args, top_live)
    n_dev = 1
    for d in dims:
        n_dev *= d
    return {
        "arch": cfg.name, "shape": shp.name,
        "mesh": "x".join(str(d) for d in dims), "n_devices": n_dev,
        "kind": shp.kind, "tag": extra_tag,
        "lower_s": round(time.perf_counter() - t0, 2),
        "compile_s": 0.0,           # eager: nothing is compiled
        **rec,
        "model": {"params": cfg.param_count,
                  "active_params": cfg.active_param_count},
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--block-kv", type=int, default=1024)
    ap.add_argument("--kv-cache-dtype", default="bf16")
    ap.add_argument("--mesh-shape", default=None,
                    help="override (data,model), e.g. 32x8")
    ap.add_argument("--tag", default="")
    ap.add_argument("--top-live", type=int, default=0,
                    help="record and print the N largest storages live at "
                         "the peak, with the ops that made them")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    cells: list[tuple[str, str]] = []
    if args.all:
        for a in ASSIGNED:
            for s in applicable_shapes(get_arch(a)):
                cells.append((a, s))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape (or --all) required")
        cells.append((args.arch, args.shape))
    remat = None if args.remat in ("none", "None") else args.remat
    ms = (tuple(int(x) for x in args.mesh_shape.split("x"))
          if args.mesh_shape else None)
    pod = "multi" if args.multipod else "single"
    failures = 0
    t_all = time.perf_counter()
    for a, s in cells:
        fn = out_dir / f"{a}__{s}__{pod}{args.tag}.json"
        if args.skip_existing and fn.exists():
            print(f"SKIP {a:24s} {s:12s} {pod}: exists", flush=True)
            continue
        try:
            rec = lower_cell(a, s, multi_pod=args.multipod, remat=remat,
                             block_kv=args.block_kv,
                             kv_cache_dtype=args.kv_cache_dtype,
                             extra_tag=args.tag, mesh_shape=ms,
                             top_live=args.top_live)
            fn.write_text(json.dumps(rec, indent=1))
            m = rec["memory"]["peak_bytes_per_device"] / 2**30
            print(f"OK   {a:24s} {s:12s} {pod}: peak {m:.2f} GiB/dev, "
                  f"flops {rec['cost']['flops']:.3e}, "
                  f"coll {rec['collectives']['total_bytes']:.3e} B "
                  f"(lower {rec['lower_s']}s)", flush=True)
            for w in rec["memory"].get("top_live", []):
                print(f"     live at peak: {w['bytes']:>14d} B {w['dtype']:9s} "
                      f"{w['shape']} {w['op']}", flush=True)
        except Exception as e:
            failures += 1
            fn.with_suffix(".err").write_text(traceback.format_exc())
            print(f"FAIL {a:24s} {s:12s} {pod}: {type(e).__name__}: {e}",
                  flush=True)
    print(f"{len(cells)} cells, {failures} failed, "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
