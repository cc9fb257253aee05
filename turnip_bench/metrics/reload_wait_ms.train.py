"""Device milliseconds a training step in which the compute stream waits
on a reload of the activation offload. For each of the program's
``turnip.offload.wait`` spans: the time from the end of the compute
stream's last device operation launched (on the span's thread) before the
span to the start of its first one launched after it, counted where the
HtoD copy of the reload it waits on (the latest ``turnip.offload.reload``
span before it on that thread) ends inside that stretch. Prints which
layers' waits were counted (the backward's waits counted from the last
layer down), and the time a step that the host-device copies run with no
kernel running, by the span that issued them."""
import bisect
import collections
import math
import sys

from .. import spans, trace

spans.install()

WAIT, RELOAD = "turnip.offload.wait", "turnip.offload.reload"
BACKWARD = "turnip.step.backward"


def _is_copy(row) -> bool:
    return row.name.startswith(("Memcpy", "Memset"))


def waits(reading) -> list[tuple[int, float]]:
    """(layer, seconds) of each counted wait; layer -1 where no backward
    span holds the wait."""
    by_thread: dict[int, list] = {}
    for r in reading.rows:
        if r.thread >= 0:
            by_thread.setdefault(r.thread, []).append(r)
    for rows in by_thread.values():
        rows.sort(key=lambda r: r.launch)
    launched = {th: [r.launch for r in rows] for th, rows in by_thread.items()}
    h2d_end: dict[int, float] = {}
    for r in reading.rows:
        if r.span >= 0 and reading.spans[r.span].name == RELOAD \
                and "HtoD" in r.name:
            h2d_end[r.span] = max(h2d_end.get(r.span, -math.inf), r.end)
    reloads: dict[int, list] = {}
    for i, s in enumerate(reading.spans):
        if s.name == RELOAD:
            reloads.setdefault(s.thread, []).append((s.start, i))
    for v in reloads.values():
        v.sort()
    backward = sorted((s.start, s.end) for s in reading.spans
                      if s.name == BACKWARD)
    per_step: dict[int, list] = {}
    for s in reading.spans:
        if s.name == WAIT:
            step = next((k for k, (a, b) in enumerate(backward)
                         if a <= s.start <= b), -1)
            per_step.setdefault(step, []).append(s)
    out = []
    for step, ws in per_step.items():
        ws.sort(key=lambda s: s.start)
        for j, w in enumerate(ws):
            layer = len(ws) - 1 - j if step >= 0 else -1
            got = _wait(w, by_thread.get(w.thread, []),
                        launched.get(w.thread, []),
                        reloads.get(w.thread, []), h2d_end)
            if got is not None:
                out.append((layer, got))
    return out


def _wait(w, rows, launched, reloads, h2d_end) -> float | None:
    after = next((r for r in rows[bisect.bisect_right(launched, w.end):]
                  if not _is_copy(r)), None)
    if after is None:
        return None
    k = bisect.bisect_left(launched, w.start)
    before = next((r for r in reversed(rows[:k])
                   if r.stream == after.stream), None)
    r = bisect.bisect_left(reloads, (w.start, -1)) - 1
    if before is None or r < 0:
        return None
    done = h2d_end.get(reloads[r][1])
    if done is None or not before.end < done <= after.start:
        return None
    return after.start - before.end


def exposed_copies(reading) -> dict[str, float]:
    """Seconds of each label's DtoH and HtoD copies in which no kernel
    runs."""
    busy = trace.union((r.start, r.end) for r in reading.rows
                       if not _is_copy(r))
    ends = [e for _, e in busy]
    out: dict[str, float] = {}
    for r in reading.rows:
        if not r.name.startswith("Memcpy") or not ("DtoH" in r.name
                                                   or "HtoD" in r.name):
            continue
        covered, k = 0.0, bisect.bisect_right(ends, r.start)
        while k < len(busy) and busy[k][0] < r.end:
            covered += min(busy[k][1], r.end) - max(busy[k][0], r.start)
            k += 1
        out[r.label] = out.get(r.label, 0.0) + (r.end - r.start - covered)
    return out


def read(run):
    reading = spans.of(run)
    if reading is None or not run.units or \
            not any(s.name == WAIT for s in reading.spans):
        return None
    got = waits(reading)
    by_layer = collections.Counter()
    for layer, sec in got:
        by_layer[layer] += sec
    print("reload_wait_ms.train: waits counted at layers "
          + ", ".join(f"{layer}: {1e3 * sec / run.units!r} ms a step"
                      for layer, sec in sorted(by_layer.items())),
          file=sys.stderr)
    print("reload_wait_ms.train: copies exposed, ms a step: "
          + ", ".join(f"{label} {1e3 * sec / run.units!r}" for label, sec
                      in sorted(exposed_copies(reading).items())),
          file=sys.stderr)
    return 1e3 * sum(sec for _, sec in got) / run.units
