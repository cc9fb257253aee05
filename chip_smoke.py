#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside this
file; it exits non-zero, and prints no result, without them. It never
imports JAX or the reference package. Phases, each timed, each fatal on
failure:

1. The card's name and power limit (``nvidia-smi``) and the build of
   every hand-written kernel from the sources in the checkout, one
   ``nvcc`` per source, into ``build/repro_torch/``.
2. Kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shape and at the reference test sweep's shapes, with
   the tolerance stated per dtype. Times are medians of CUDA-event times
   over repeated launches with the L2 cache flushed in between;
   ``bound`` is the least time the card could take (bytes over 3.35 TB/s
   or operations over the peak rate of their type, the larger).
3. Main path: TURNIP's offloaded prefill, traced at llama-7b's full
   width (d_model 4096, 32 heads, d_ff 11008, vocab 32000) and cut to 8
   layers at S=2048 in float16 as ``benchmarks/fig10_prefill.py`` cuts
   it, planned under fig10's tightest HBM budget scaled to the depth so
   that weights and activations are offloaded, and run by
   ``TurnipRuntime`` on the ByteArena in HBM with pinned host memory:
   one warm-up, then four dispatch policies and ``mode='fixed'``. Every
   run's logits are held against the port's plain evaluation
   (``eval_taskgraph``, no plan, plain kernels) and against each other.

``--profile`` adds one more run of the main path under ``torch.profiler``
and prints the card's busy time (the union of its kernel and copy
intervals) and the device time by kernel name.

The line before the last is ``{"kernels": [...]}``, one record per kernel
of the path; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                  # H100 SXM f32 outside the tensor cores
# kernel-vs-plain tolerance per dtype: |k - p| <= atol + rtol * |p|. The
# two differ only in the f32 summation order and the final rounding to
# the storage type, so the tolerance is about one unit in the last place.
KERNEL_TOL = {"float32": (2e-5, 2e-4), "float16": (2e-3, 2e-3),
              "bfloat16": (3e-2, 3e-2)}
# logits tolerance, relative to the largest reference logit: float16 keeps
# ~3 decimal digits, and the runs differ from the plain evaluation in the
# order of the streaming sums (the paper's sanctioned nondeterminism) and
# in the kernel's rounding, compounded over 8 layers
LOGIT_RTOL = 2e-2

MAIN_LAYERS = 8
MAIN_SEQ = 2048
POLICY_RUNS = [("random", "nondet"), ("fixed", "nondet"),
               ("critical-path", "nondet"), ("transfer-first", "nondet"),
               ("fixed", "fixed")]


def _phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _median_ms(fn, torch, flush, reps: int = 30) -> float:
    """Median CUDA-event time of one call, the L2 cache flushed before
    each call. The flush (512 MiB of writes, ~0.2 ms of device time) is
    outside the timed window, and it keeps the card busy while the host
    enqueues the call, so the window holds the call's device time and not
    the host's launch overhead."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rmsnorm_bound_ms(n_rows: int, d: int, itemsize: int) -> tuple[float, str]:
    """Least time for rmsnorm on [n_rows, d]: read x and g once, write y
    once; 4 f32 operations per element (square, sum, two scalings)."""
    t_bytes = (2 * n_rows * d + d) * itemsize / HBM_BYTES_PER_S
    t_ops = 4 * n_rows * d / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, device) -> dict:
    """rmsnorm against rmsnorm_plain on the card. Returns the record of
    the main path's shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_plain

    gen = torch.Generator(device=device).manual_seed(0)
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=device)
    cases = [((2048, 4096), torch.float16)]
    for shape in [(7, 128), (3, 33, 256), (1, 512)]:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            cases.append((shape, dt))
    main = None
    for i, (shape, dt) in enumerate(cases + [("arena", torch.float16)]):
        arena = shape == "arena"
        if arena:
            # out is a typed view at a 2-byte offset into a uint8 buffer, as
            # an unaligned arena extent: the kernel's scalar path
            shape = (64, 4096)
        x = torch.randn(shape, generator=gen, device=device).to(dt)
        g = torch.randn(shape[-1:], generator=gen, device=device).to(dt)
        if arena:
            nb = x.numel() * x.element_size()
            buf = torch.zeros(nb + 2, dtype=torch.uint8, device=device)
            out = buf[2:2 + nb].view(dt).view(shape)
            y = rmsnorm(x, g, out=out)
            assert y.data_ptr() == out.data_ptr()
        else:
            y = rmsnorm(x, g)
        torch.cuda.synchronize()
        p = rmsnorm_plain(x, g)
        name = str(dt).removeprefix("torch.")
        atol, rtol = KERNEL_TOL[name]
        err = (y.float() - p.float()).abs()
        lim = atol + rtol * p.float().abs()
        max_err = err.max().item()
        ok = bool((err <= lim).all())
        n_rows, d = x.numel() // shape[-1], shape[-1]
        k_ms = _median_ms(lambda: rmsnorm(x, g, out=y), torch, flush)
        p_ms = _median_ms(lambda: rmsnorm_plain(x, g), torch, flush)
        lib_ms = None
        if hasattr(F, "rms_norm"):
            lib_ms = _median_ms(
                lambda: F.rms_norm(x, (d,), weight=g, eps=1e-6), torch, flush)
        bound_ms, bound_by = rmsnorm_bound_ms(n_rows, d, x.element_size())
        label = "arena-view+2B" if arena else "x".join(map(str, shape))
        print(f"kernel rmsnorm {label} {name}: max_abs_err {max_err:.3g} "
              f"(tol {atol:g} + {rtol:g}*|plain|) ok={ok} "
              f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
              f"library_ms {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} "
              f"bound_ms {bound_ms:.4f} ({bound_by})", flush=True)
        if not ok:
            raise AssertionError(f"rmsnorm kernel disagrees with its plain "
                                 f"version at {label} {name}")
        if i == 0:
            main = dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=lib_ms)
    del flush
    return main


def build_main_path(*, arch=None, seq_len=MAIN_SEQ, n_layers=MAIN_LAYERS,
                    head_group=8, q_block=512, mlp_slices=2,
                    dtype="float16", budgets_gib=(3.0, 1.5)):
    """Trace and plan the offloaded prefill. Returns (traced, result,
    capacity in bytes).

    The HBM budget starts at fig10's tightest, 3 GiB for the 32-layer
    model, scaled to the depth. At S=2048 that budget streams every weight
    from host memory but fits the activations, so nothing is offloaded;
    the next budget, half of it, makes the plan offload activations and
    reload them. The first budget of ``budgets_gib`` whose plan offloads
    is taken; each attempt is printed."""
    from repro_torch.configs import get_arch
    from repro_torch.core import BuildConfig, build_memgraph
    from repro_torch.core.trace import TraceConfig, trace_prefill

    cfg = arch if arch is not None else get_arch("llama-7b")
    tr = trace_prefill(cfg, seq_len=seq_len, n_layers=n_layers,
                       trace=TraceConfig(n_devices=1, head_group=head_group,
                                         q_block=q_block,
                                         mlp_slices=mlp_slices, dtype=dtype))

    def size_fn(v):          # 256-byte extents: the kernel's 16-byte loads
        return -(-v.out.nbytes // 256) * 256

    for budget_gib in budgets_gib:
        cap = int(budget_gib * 2**30 * n_layers / cfg.n_layers)
        res = build_memgraph(tr.tg, BuildConfig(capacity=cap,
                                                size_fn=size_fn))
        print(f"budget {budget_gib} GiB x {n_layers}/{cfg.n_layers} = {cap} "
              f"B: offloads {res.n_offloads} reloads {res.n_reloads}",
              flush=True)
        if res.n_offloads > 0 and res.n_reloads > 0:
            return tr, res, cap
    raise RuntimeError("no budget makes the plan offload")


def profile_run(torch, run) -> None:
    """One run under torch.profiler: the card's busy time and idle share
    over the run, and device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rr = run()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + (b - a) / 1e3, n + 1)
    if not spans:
        print("profile: no device events recorded (device busy time not "
              "measured)", flush=True)
        return
    spans.sort()
    busy_us, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy_us += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy_us += cur_b - cur_a
    window_ms = (max(b for _, b in spans) - spans[0][0]) / 1e3
    print(f"profile: makespan_ms {rr.makespan * 1e3:.2f} device_window_ms "
          f"{window_ms:.2f} device_busy_ms {busy_us / 1e3:.2f} "
          f"device_idle_share_of_makespan "
          f"{1 - busy_us / 1e3 / (rr.makespan * 1e3):.3f} "
          f"device_events {len(spans)}", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        print(f"profile: {ms:9.3f} ms {n:5d}x {name[:100]}", flush=True)


def run_main_path(torch, device, tr, res, cap, inputs, *, n_rms: int,
                  profile: bool = False):
    """Warm-up plus the policy runs. Returns the launches of each kernel
    over the measured runs."""
    from repro_torch.core.runtime import TurnipRuntime, eval_taskgraph
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    L = tr.meta["logits"]
    t = time.perf_counter()
    ref = eval_taskgraph(tr.tg, inputs, device=device, plain=True)[L]
    if device.type == "cuda":
        torch.cuda.synchronize()
    scale = ref.float().abs().max().item()
    assert torch.isfinite(ref).all() and scale > 0, "plain logits not finite"
    _phase("plain evaluation", t)

    def runtime(policy, mode):
        return TurnipRuntime(tr.tg, res, backend="bytes", capacities={0: cap},
                             policy=policy, mode=mode, seed=0, device=device)

    t = time.perf_counter()
    runtime("random", "nondet").run(inputs)          # warm-up: pinned pools,
    _phase("warm-up run", t)                         # cuBLAS handles
    rmsnorm.launches = 0                  # the main path starts here
    first = None
    for policy, mode in POLICY_RUNS:
        before = rmsnorm.launches
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        rr = runtime(policy, mode).run(inputs)
        n = rmsnorm.launches - before
        excess = None
        if device.type == "cuda":
            torch.cuda.synchronize()
            excess = torch.cuda.max_memory_allocated() - base - rr.arena_bytes
        out = rr.outputs[L]
        assert out.device.type == device.type and \
            rr.arena_device.startswith(device.type), "run left the device"
        assert all(v.device.type == device.type for v in rr.outputs.values())
        assert out.shape == ref.shape and torch.isfinite(out).all()
        err = (out.float() - ref.float()).abs().max().item()
        if first is None:
            first = out
        err_runs = (out.float() - first.float()).abs().max().item()
        busy, stall = rr.busy[0], rr.stall[0]
        print(f"run policy={policy} mode={mode}: makespan_ms "
              f"{rr.makespan * 1e3:.2f} busy_ms {busy * 1e3:.2f} stall_ms "
              f"{stall * 1e3:.2f} idle_share {stall / rr.makespan:.3f} "
              f"offload_bytes {rr.offload_bytes} reload_bytes "
              f"{rr.reload_bytes} h2d_s {rr.transfer_time['h2d']:.4f} "
              f"d2h_s {rr.transfer_time['d2h']:.4f} compute_launch_s "
              f"{rr.launch_time.get('compute', 0.0):.4f} "
              f"rmsnorm_launches {n} "
              f"excess_over_arena_bytes {excess} arena_bytes "
              f"{rr.arena_bytes} logits_max_err_vs_plain {err:.3g} "
              f"(tol {LOGIT_RTOL:g}*{scale:.3g}) max_err_vs_first_run "
              f"{err_runs:.3g}", flush=True)
        assert n == n_rms, f"rmsnorm launched {n} times, expected {n_rms}"
        assert err <= LOGIT_RTOL * scale, "logits disagree with plain eval"
        assert err_runs <= LOGIT_RTOL * scale, "logits disagree across runs"
    launches = {"rmsnorm": rmsnorm.launches}
    if profile:
        profile_run(torch, lambda: runtime("fixed", "nondet").run(inputs))
    return launches


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core.bridge import inputs_from_reference
    from repro_torch.kernels import build

    device = torch.device("cuda", 0)
    t_all = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t = time.perf_counter()
    build.build_all()
    for name, (secs, log) in sorted(build.build_log.items()):
        print(f"build {name}: nvcc {secs:.2f} s", flush=True)
        for line in log.splitlines():       # ptxas: registers and spills
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}", flush=True)
    _phase("build", t)

    t = time.perf_counter()
    rms = kernel_phase(torch, device)
    print("kernels: rmsnorm", flush=True)
    _phase("kernels", t)

    t = time.perf_counter()
    tr, res, cap = build_main_path()
    print(f"main path: llama-7b width, {MAIN_LAYERS} layers, S={MAIN_SEQ}, "
          f"float16; {len(tr.tg)} task vertices, {len(res.memgraph)} "
          f"memgraph vertices; HBM budget {cap} B; offloads "
          f"{res.n_offloads} reloads {res.n_reloads}", flush=True)
    _phase("trace and plan", t)
    t = time.perf_counter()
    inputs = inputs_from_reference(tr.make_inputs(seed=0), device=device)
    host_bytes = sum(v.numel() * v.element_size() for v in inputs.values())
    print(f"inputs: {host_bytes} B pinned host memory", flush=True)
    _phase("inputs", t)

    t = time.perf_counter()
    launches = run_main_path(torch, device, tr, res, cap, inputs,
                             n_rms=2 * MAIN_LAYERS + 1,
                             profile="--profile" in argv)
    _phase("main path", t)
    if launches["rmsnorm"] == 0:
        raise AssertionError("the main path launched no rmsnorm kernel")

    record = dict(name="rmsnorm", route="cuda",
                  source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                  replaces="src/repro/kernels/rmsnorm/kernel.py:13",
                  launches=launches["rmsnorm"], **rms)
    _phase("total", t_all)
    print(card, flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
