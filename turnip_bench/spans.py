"""The program's spans in a traced window: each device row put down to the
innermost ``turnip.*`` span of the program that caused it.

The port marks its work with profiler ranges (``repro_torch/spans.py``:
the step's phases, a layer, an RWKV block's halves and mixes, the LoRA
merge, the offload's copies and waits, each hand-written kernel's calls).
A device row (a kernel, copy or memset) is tied to the host by its
correlation id, which leads to the host call that launched it; the spans
open on that thread at that moment say what the program was doing. A row
is labelled with the innermost span and how it was caused:

* ``<span>``: launched inside the span in the forward;
* ``<span>:recompute``: launched inside the span and inside a backward
  node, below a ``turnip.layer`` that the node opened: the checkpoint's
  replay of a layer;
* ``<span>:backward``: launched inside a backward node, and either inside
  a span the node itself opened (a backward kernel's, the offload's
  reload) or, where it opened none, under the span of the forward
  operator that made the node, found by the node's forward thread and
  sequence number;
* ``(autograd)``: launched by the autograd engine itself, between nodes
  or inside a node's evaluation but outside its function: the sums of a
  gradient that several uses of a tensor feed;
* ``(no span)``: anything else (the harness's own work, a launch the
  trace does not tie to the host).

:func:`read` builds a :class:`Reading` from a profile; ``install`` makes
the harness's ``trace.from_profiler`` attach one to every ``Timeline`` it
returns (as ``timeline.program``) and its ``traced_metrics`` add the
``device_spans`` and ``idle_spans`` breakdowns, leaving everything else it
returns as it was. A made-up timeline, or a profile of a program without
spans, has no reading or an empty one, and the readers of the spans find
nothing to read there.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import typing

from . import trace
from .metrics._read import GEMM_MARKS

__all__ = ["Span", "Row", "Reading", "Host", "Device", "extract",
           "attribute", "read", "of", "span_ms", "device_spans",
           "idle_spans", "by_label", "summary", "install", "PREFIX", "NODE",
           "NO_SPAN", "AUTOGRAD"]

PREFIX = "turnip."
NODE = "autograd::engine::evaluate_function: "
NO_SPAN = "(no span)"
AUTOGRAD = "(autograd)"
LAYER = "turnip.layer"
TOP = 12                   # spans in the breakdown


class Span(typing.NamedTuple):
    """A program span on the host: seconds from the window's start."""
    name: str
    start: float
    end: float
    thread: int


class Row(typing.NamedTuple):
    """A device row, its label and what it was put down to: ``span`` is the
    index in ``Reading.spans`` of the span the label names (-1: none);
    ``launch`` and ``thread`` the host call that launched the row (nan and
    -1 where the trace does not tie it to one)."""
    name: str
    start: float
    end: float
    stream: int
    label: str
    span: int
    launch: float
    thread: int

    @property
    def span_name(self) -> str:
        return self.label.split(":", 1)[0]


@dataclasses.dataclass
class Reading:
    spans: list[Span]
    rows: list[Row]


# ---------------------------------------------------------------- events
class Host(typing.NamedTuple):
    """A host event the reading needs, in seconds from the window's start.
    ``kind``: ``"span"`` (a program span), ``"node"`` (a backward node's
    evaluation; ``a``, ``b`` its forward thread and sequence number),
    ``"body"`` (the node's own function, inside its evaluation), ``"op"``
    (a forward operator under grad; ``a`` its sequence number) or
    ``"launch"`` (a runtime call, which the trace links to an operator;
    ``a`` its correlation id)."""
    kind: str
    name: str
    start: float
    end: float
    thread: int
    a: int = 0
    b: int = 0


class Device(typing.NamedTuple):
    """A device row as ``trace.Timeline`` holds it, with the correlation id
    of the runtime call that launched it."""
    name: str
    start: float
    end: float
    stream: int
    corr: int


_BACKWARD_FUNCTION = 1     # at::RecordScope of a backward node's function


def extract(prof) -> tuple[list[Host], list[Device]]:
    """The host events and device rows of ``prof`` (a stopped
    ``torch.profiler.profile``) that start inside the window span, the
    rows chosen as ``trace.from_profiler`` chooses them."""
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == trace.WINDOW_SPAN
              and e.device_type().name == "CPU"]
    if len(window) != 1:
        return [], []
    t0, length = window[0].start_ns(), window[0].duration_ns() * 1e-9
    host, device = [], []
    for e in events:
        start = (e.start_ns() - t0) * 1e-9
        if start < 0 or start > length:
            continue
        name, end = e.name(), start + e.duration_ns() * 1e-9
        on_card = e.device_type().name == "CUDA"
        if e.is_user_annotation():
            if not on_card and name.startswith(PREFIX):
                host.append(Host("span", name, start, end,
                                 e.start_thread_id()))
        elif on_card:
            device.append(Device(name, start, end,
                                 int(e.device_resource_id()),
                                 e.correlation_id()))
        elif e.linked_correlation_id() > 0:      # a runtime call
            host.append(Host("launch", name, start, end,
                             e.start_thread_id(), e.correlation_id()))
        else:                                    # an operator
            th = e.start_thread_id()
            if name.startswith(NODE):
                host.append(Host("node", name, start, end, th,
                                 e.fwd_thread_id(), e.sequence_nr()))
            elif e.scope() == _BACKWARD_FUNCTION:
                host.append(Host("body", name, start, end, th))
            elif e.sequence_nr() >= 0 and e.fwd_thread_id() == 0:
                host.append(Host("op", name, start, end, th,
                                 e.sequence_nr()))
    return host, device


# ------------------------------------------------------------------ sweep
def _stacks(items: list[Host], times: list[float]) -> list[list[Host]]:
    """For each time, ascending, the items of one thread that enclose it,
    outermost first (they nest, so a stack suffices)."""
    items = sorted(items, key=lambda it: (it.start, -it.end))
    out, stack, j = [], [], 0
    for t in times:
        while j < len(items) and items[j].start <= t:
            while stack and stack[-1].end < items[j].start:
                stack.pop()
            stack.append(items[j])
            j += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append([it for it in stack if it.end >= t])
    return out


def _innermost(stack: list[Host], kind: str) -> int:
    for k in range(len(stack) - 1, -1, -1):
        if stack[k].kind == kind:
            return k
    return -1


def attribute(host: list[Host], device: list[Device]) -> Reading:
    """Each device row labelled by the spans around its launch (see the
    module's docstring)."""
    spans: list[Span] = []
    index: dict[int, int] = {}            # id of a span's Host -> its index
    per_thread: dict[int, list[Host]] = {}
    node_threads: set[int] = set()
    forward: dict[tuple[int, int], float] = {}
    launches: dict[int, tuple[float, int]] = {}
    for h in host:
        if h.kind in ("span", "node", "body"):
            per_thread.setdefault(h.thread, []).append(h)
        if h.kind == "span":
            index[id(h)] = len(spans)
            spans.append(Span(h.name, h.start, h.end, h.thread))
        elif h.kind == "node":
            node_threads.add(h.thread)
        elif h.kind == "op":
            # several operators may read one sequence number before the
            # node takes it: the one that made the node started last
            key = (h.thread, h.a)
            forward[key] = max(forward.get(key, h.start), h.start)
        elif h.kind == "launch":
            launches[h.a] = (h.start, h.thread)

    # each device row's launch: the runtime call with its correlation id
    # (none where the profiler lost it)
    nowhere = (math.nan, -1)
    placed = [launches.get(d.corr, nowhere) for d in device]

    # what encloses each launch, and each forward operator, in one sweep
    # of each thread
    queries: dict[int, list] = {}
    for (th, seq), start in forward.items():
        queries.setdefault(th, []).append((start, (th, seq)))
    for i, (at, th) in enumerate(placed):
        if th >= 0:
            queries.setdefault(th, []).append((at, i))
    fwd_span: dict[tuple[int, int], int] = {}
    enclosing: dict[int, list[Host]] = {}
    for th, qs in queries.items():
        qs.sort(key=lambda q: q[0])
        stacks = _stacks(per_thread.get(th, []), [q[0] for q in qs])
        for (_, ref), stack in zip(qs, stacks):
            if isinstance(ref, tuple):
                k = _innermost(stack, "span")
                fwd_span[ref] = index[id(stack[k])] if k >= 0 else -1
            else:
                enclosing[ref] = stack

    def label(stack: list[Host], th: int) -> tuple[str, int]:
        span_at = _innermost(stack, "span")
        node_at = _innermost(stack, "node")
        if span_at > node_at:
            idx = index[id(stack[span_at])]
            if node_at < 0:
                return spans[idx].name, idx
            replay = any(h.kind == "span" and h.name == LAYER
                         for h in stack[node_at + 1:])
            return (spans[idx].name
                    + (":recompute" if replay else ":backward"), idx)
        if node_at >= 0:
            node = stack[node_at]
            if _innermost(stack, "body") < node_at:
                return AUTOGRAD, -1          # the engine's own, e.g. sums
            idx = fwd_span.get((node.a, node.b), -1)
            return ((spans[idx].name + ":backward", idx) if idx >= 0
                    else (NO_SPAN, -1))
        return (AUTOGRAD if th in node_threads else NO_SPAN), -1

    rows = []
    for i, (d, (at, th)) in enumerate(zip(device, placed)):
        name, idx = label(enclosing[i], th) if i in enclosing \
            else (NO_SPAN, -1)
        rows.append(Row(d.name, d.start, d.end, d.stream, name, idx, at, th))
    rows.sort(key=lambda r: r.start)
    return Reading(spans, rows)


def read(prof) -> Reading:
    """The reading of a stopped ``torch.profiler.profile``."""
    return attribute(*extract(prof))


# --------------------------------------------------------------- readings
def of(run) -> Reading | None:
    """The run's reading, or None where it holds no program span."""
    reading = getattr(run.timeline, "program", None)
    return reading if reading is not None and reading.spans else None


def span_ms(run, name: str) -> float | None:
    """Device milliseconds a step of the rows put down to the span
    ``name``, however caused (forward, recompute, backward)."""
    reading = of(run)
    if reading is None or not run.units:
        return None
    rows = [r for r in reading.rows if r.span_name == name]
    if not rows:
        return None
    return 1e3 * sum(r.end - r.start for r in rows) / run.units


def device_spans(reading: Reading, top: int = TOP) -> list[list]:
    """The ``top`` labels by device seconds, ``[label, seconds]``."""
    tot: dict[str, float] = {}
    for r in reading.rows:
        tot[r.label] = tot.get(r.label, 0.0) + (r.end - r.start)
    return [[k, v] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def idle_spans(tl: trace.Timeline, reading: Reading) -> list[list]:
    """``trace.idle_gaps``'s gaps, each named by the innermost program
    span open at its middle (on any thread), ``[name, seconds]``."""
    named = trace.Timeline(tl.kernels, tl.copies,
                           [(s.name, s.start, s.end) for s in reading.spans],
                           tl.window_s)
    return [[NO_SPAN if name == "no host operator" else name, sec]
            for name, sec in trace.idle_gaps(named)]


def by_label(reading: Reading, marks: tuple[str, ...],
             top: int = TOP) -> list[list]:
    """The ``top`` labels by device seconds of the rows whose name holds
    one of ``marks`` (lower case), ``[label, seconds]``."""
    tot: dict[str, float] = {}
    for r in reading.rows:
        if any(m in r.name.lower() for m in marks):
            tot[r.label] = tot.get(r.label, 0.0) + (r.end - r.start)
    return [[k, v] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def summary(reading: Reading) -> str:
    """Lines for standard error: the window's device seconds, the rows the
    trace does not tie to a host launch, how much of it is under no span
    and under the engine, and the elementwise kernels' and the GEMMs'
    seconds by label."""
    tot = sum(r.end - r.start for r in reading.rows)
    part = {k: sum(r.end - r.start for r in reading.rows if r.label == k)
            for k in (NO_SPAN, AUTOGRAD)}
    untied = sum(1 for r in reading.rows if r.thread < 0)
    lines = [f"spans: {len(reading.spans)} program spans, "
             f"{len(reading.rows)} device rows ({untied} not tied to a "
             f"launch), {tot!r} device s; {NO_SPAN} {part[NO_SPAN]!r} s, "
             f"{AUTOGRAD} {part[AUTOGRAD]!r} s"]
    for what, marks in (("elementwise", ("elementwise_kernel",)),
                        ("gemm", GEMM_MARKS)):
        lines.append(f"spans: {what} s by label: "
                     + "; ".join(f"{k} {v!r}" for k, v in
                                 by_label(reading, marks, 3 * TOP)))
    where: dict[tuple[str, str], int] = {}
    for r in reading.rows:
        kind = ("wkv6" if trace.base_name(r.name).startswith("wkv6")
                else r.name[:11] if r.name.startswith(("Memcpy DtoH",
                                                       "Memcpy HtoD"))
                else None)
        if kind:
            where[kind, r.span_name] = where.get((kind, r.span_name), 0) + 1
    lines.append("spans: wkv6 kernels and host copies by span: "
                 + "; ".join(f"{k} under {n} {c}" for (k, n), c in
                             sorted(where.items())))
    return "\n".join(lines)


# ---------------------------------------------------------------- install
def install() -> None:
    """Make ``trace.from_profiler`` attach a :class:`Reading` to the
    timeline it returns, and ``harness.traced_metrics`` add the
    ``device_spans`` and ``idle_spans`` breakdowns. Idempotent."""
    from . import harness
    if getattr(trace.from_profiler, "reads_spans", False):
        return
    base_from_profiler = trace.from_profiler
    base_traced = harness.traced_metrics

    def from_profiler(prof):
        tl = base_from_profiler(prof)
        tl.program = read(prof)
        print(summary(tl.program), file=sys.stderr)
        return tl

    def traced_metrics(run):
        metrics, breakdown = base_traced(run)
        reading = of(run)
        if reading is not None:
            breakdown["device_spans"] = device_spans(reading)
            breakdown["idle_spans"] = idle_spans(run.timeline, reading)
        return metrics, breakdown

    from_profiler.reads_spans = True
    trace.from_profiler = from_profiler
    harness.traced_metrics = traced_metrics
