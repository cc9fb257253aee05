"""What every cell's run shares: finding a cell's pieces by name, the
measured window, the per-layer metrics of a traced run, the comparison's
printout and the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix; the harness finds

* ``configs/<config>.json``: the published configuration and, under
  ``as_run``, the program's ``ArchConfig`` fields;
* ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  generator that runs it, ``drivers/<kind>.py``;
* ``cells/<workload>.json``: the limits of the comparison that decides
  ``correct``, with the readings they were set from;
* ``metrics/<metric>.py``, one per per-layer metric of ``BENCHMARK.json``:
  ``read(run)`` returns the metric's value, or None where the run holds
  nothing for it to read; its ``COUNTERS``, if any, name the program's
  counters it reads (``program_counters``);
* ``reference/<family>.py``: the plain float32 reference of the
  configuration's family.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
from typing import Any

import torch

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "repro")

__all__ = ["Cell", "load_cell", "banned_modules", "program_counters",
           "measure", "Run", "traced_metrics", "checks_block", "result_line",
           "power_limit"]


@dataclasses.dataclass
class Cell:
    """One run of one cell."""
    name: str
    config: dict                  # the configuration file
    traffic: dict                 # the traffic file
    limits: dict                  # {number: limit}
    seed: int
    seconds: float
    trace: bool
    chips: int = 1
    per_layer: list = dataclasses.field(default_factory=list)

    @property
    def arch(self) -> dict:
        return self.config["as_run"]


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, seed: int, seconds: float,
              trace: bool) -> Cell:
    """The cell ``workload`` of the checkout's ``BENCHMARK.json``, its
    metrics limited to those that name it (or name no cells)."""
    bench = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[workload]

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]
    return Cell(name=workload,
                config=_json(HERE / "configs" / f"{w['config']}.json"),
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_json(HERE / "cells" / f"{workload}.json")["limits"],
                seed=seed, seconds=seconds, trace=trace, chips=w["chips"],
                per_layer=mine(bench["per_layer"]))


def driver(kind: str):
    return importlib.import_module(f"turnip_bench.drivers.{kind}")


def reference(family: str):
    return importlib.import_module(f"turnip_bench.reference.{family}")


def _counter(where: str):
    """The value at ``"<module>:<name>.<name>..."``: the module imported,
    then each name an attribute, or a key of a dict."""
    module, _, path = where.partition(":")
    obj = importlib.import_module(module)
    for name in path.split("."):
        obj = obj[name] if isinstance(obj, dict) else getattr(obj, name)
    return obj


def program_counters(cell: Cell) -> dict:
    """The current values of the program's counters that the cell's
    per-layer metrics read: each metric file's ``COUNTERS`` maps the name
    its ``read`` looks up in ``Run.counters`` to where the counter lives
    (``"repro_torch.kernels.rwkv6.ops:wkv6_bwd.launches"``). A driver
    reads them before and after its window and hands on the difference."""
    out = {}
    for m in cell.per_layer:
        for name, where in getattr(metric_module(m["name"]), "COUNTERS",
                                   {}).items():
            out[name] = _counter(where)
    return out


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``BANNED`` (compared
    whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in BANNED})


def device_info(cell: Cell, peak_bytes: int) -> dict:
    """The result line's ``device``: the card's name, the cards used and
    the peak of allocated memory on the fullest one."""
    cuda = torch.cuda.is_available()
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def measure(cell: Cell, device: torch.device, window):
    """Runs ``window()``, the measured window, once set-up is done: with
    ``--trace 1`` under ``torch.profiler``. Returns (what ``window``
    returned, the result line's ``device``, the window's peak of allocated
    bytes, the trace's ``Timeline`` or None). The device's peak is the
    larger of set-up's and the window's."""
    from . import trace
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if cell.trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    w = window()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    dev = device_info(cell, max(setup_peak, peak))
    tl = None
    if prof is not None:
        prof.stop()
        tl = trace.from_profiler(prof)
        dev.update(busy_s=trace.union_length((d[1], d[2])
                                             for d in tl.device()),
                   window_s=tl.window_s)
    return w, dev, peak, tl


@dataclasses.dataclass
class Run:
    """What a traced window leaves for the per-layer metrics to read."""
    cell: Cell
    window_s: float
    units: int                    # steps or requests completed
    lengths: list                 # tokens of each sequence of each unit
    timeline: Any = None          # trace.Timeline
    spans: dict = dataclasses.field(default_factory=dict)   # name -> [s]
    counters: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0


def metric_module(name: str):
    """``metrics/<name>.py`` (a metric's name holds dots, so it is loaded
    by its path, as a module of the ``metrics`` package)."""
    mod_name = "turnip_bench.metrics." + name.replace(".", "__")
    if mod_name not in sys.modules:
        importlib.import_module("turnip_bench.metrics")
        spec = importlib.util.spec_from_file_location(
            mod_name, HERE / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[mod_name]


def per_layer(run: Run) -> dict:
    """Every per-layer metric of the cell that has something to read."""
    out = {}
    for m in run.cell.per_layer:
        value = metric_module(m["name"]).read(run)
        if value is None:
            print(f"metric {m['name']}: nothing to read", file=sys.stderr)
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def traced_metrics(run: Run) -> tuple[dict, dict]:
    """(the cell's per-layer metrics, the ``breakdown``) of a traced
    window."""
    from . import trace
    return per_layer(run), {"device_ops": trace.device_ops(run.timeline),
                            "idle_gaps": trace.idle_gaps(run.timeline)}


def checks_block(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(whether every compared number is within its limit, the numbers
    beside their limits). A number that is not finite fails."""
    block, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        good = math.isfinite(value) and value <= limit
        ok = ok and good
        # a number that is not finite prints as null (JSON has no NaN)
        block[name] = {"value": value if math.isfinite(value) else None,
                       "limit": limit}
    return ok, block


def print_checks(block: dict) -> None:
    for name, c in block.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown: dict | None = None) -> dict:
    out: dict = {"correct": bool(correct), "attempted": int(attempted),
                 "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks          # last, as the contract asks
    return out
