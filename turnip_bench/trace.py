"""The traced run's device timeline: what ``torch.profiler`` recorded in the
measured window, reduced to plain lists that the per-layer metrics read.

``Timeline`` holds the device's kernels, copies and memsets as ``(name,
start_s, end_s, stream)`` and the host's operators as ``(name, start_s,
end_s)``, all in seconds from the window's start. Tests build one from
made-up intervals; :func:`from_profiler` builds one from a profile.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np

__all__ = ["Timeline", "from_profiler", "union", "union_length",
           "subtract_length", "base_name", "match_calls", "idle_gaps",
           "device_ops", "WINDOW_SPAN"]


@dataclasses.dataclass
class Timeline:
    kernels: list[tuple[str, float, float, int]]
    copies: list[tuple[str, float, float, int]]     # Memcpy and Memset
    host: list[tuple[str, float, float]]
    window_s: float

    def device(self) -> list[tuple[str, float, float, int]]:
        return self.kernels + self.copies


WINDOW_SPAN = "turnip_bench.window"


def from_profiler(prof) -> Timeline:
    """The events of ``prof`` (a stopped ``torch.profiler.profile`` with
    CPU and CUDA activities) that start inside the measured window: the
    harness's span ``WINDOW_SPAN``, which the timeline's clock starts
    at."""
    events = prof.profiler.kineto_results.events()
    spans = [e for e in events if e.name() == WINDOW_SPAN
             and e.device_type().name == "CPU"]
    if len(spans) != 1:
        raise RuntimeError(f"the profile holds {len(spans)} window spans")
    t0_ns = spans[0].start_ns()
    window_s = spans[0].duration_ns() * 1e-9
    kernels, copies, host = [], [], []
    for e in events:
        start = (e.start_ns() - t0_ns) * 1e-9
        end = start + e.duration_ns() * 1e-9
        if start < 0 or start > window_s:
            continue
        name = e.name()
        if e.is_user_annotation():          # the harness's spans
            continue
        if e.device_type().name == "CUDA":
            row = (name, start, end, int(e.device_resource_id()))
            (copies if name.startswith(("Memcpy", "Memset")) else
             kernels).append(row)
        else:
            host.append((name, start, end))
    return Timeline(sorted(kernels, key=lambda r: r[1]),
                    sorted(copies, key=lambda r: r[1]), host, window_s)


def union(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out: list[list[float]] = []
    for s, e in sorted((float(s), float(e)) for s, e in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def subtract_length(a, b) -> float:
    """The length of the union of ``a`` outside the union of ``b``."""
    ua, ub = union(a), union(b)
    total, j = 0.0, 0
    for s, e in ua:
        cur = s
        while j < len(ub) and ub[j][1] <= cur:
            j += 1
        k = j
        while k < len(ub) and ub[k][0] < e:
            if ub[k][0] > cur:
                total += ub[k][0] - cur
            cur = max(cur, ub[k][1])
            k += 1
        if cur < e:
            total += e - cur
    return total


_ANON = "(anonymous namespace)::"
_TEMPLATE = re.compile(r"<.*")


def base_name(kernel: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters: ``void (anonymous namespace)::ssd_pass<4,
    true>((anonymous namespace)::Params)`` -> ``ssd_pass``."""
    name = kernel.replace(_ANON, "").split("(", 1)[0]
    name = _TEMPLATE.sub("", name).strip()
    return name.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def match_calls(kernels, pattern: list[str]) -> list[list[tuple]]:
    """The calls of an operator whose launches are the kernels ``pattern``
    (base names) back to back on one stream: each call is the list of its
    kernel rows, in order."""
    by_stream: dict[int, list] = {}
    for row in kernels:
        by_stream.setdefault(row[3], []).append(row)
    calls = []
    n = len(pattern)
    for rows in by_stream.values():
        names = [base_name(r[0]) for r in rows]
        i = 0
        while i + n <= len(rows):
            if names[i:i + n] == pattern:
                calls.append(rows[i:i + n])
                i += n
            else:
                i += 1
    return calls


def idle_gaps(tl: Timeline, top: int = 10) -> list[list]:
    """The ``top`` longest stretches of the window in which no device
    operation ran, each named by the host operator that was running at
    its middle (the innermost one), as ``[name, seconds]``."""
    busy = union((r[1], r[2]) for r in tl.device())
    gaps, cur = [], 0.0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < tl.window_s:
        gaps.append((cur, tl.window_s))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    if not gaps:
        return []
    names = [h[0] for h in tl.host]
    starts = np.array([h[1] for h in tl.host] or [0.0])
    ends = np.array([h[2] for h in tl.host] or [0.0])
    out = []
    for s, e in gaps:
        mid = (s + e) / 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0] \
            if tl.host else []
        name = (names[inside[np.argmax(starts[inside])]] if len(inside)
                else "no host operator")
        out.append([name, e - s])
    return out


def device_ops(tl: Timeline, top: int = 10) -> list[list]:
    """The ``top`` device operations by total time, ``[name, seconds]``."""
    tot: dict[str, float] = {}
    for name, s, e, _ in tl.device():
        tot[name] = tot.get(name, 0.0) + (e - s)
    return [[n[:200], t] for n, t in
            sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
