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
   the main paths' shapes and at the reference test sweep's shapes, with
   the tolerance stated per dtype. Times are medians of CUDA-event times
   over repeated launches with the L2 cache flushed in between;
   ``bound`` is the least time the card could take (bytes over 3.35 TB/s
   or operations over the peak rate of their type, the larger).
   The rmsnorm kernel at [2048, 4096] float16 and the reference sweep;
   the flash-attention kernel at the serving prefill's shape (8 x 768,
   32 heads of 128, causal, bfloat16), at the paper's prompt (1 x 2048),
   on ``tests/test_kernels.py``'s sweep and on two ``q_offset > 0`` cases,
   each in float32, bfloat16 and float16. The library time is one
   PyTorch call computing the same function (``F.rms_norm``,
   ``F.scaled_dot_product_attention``), a yardstick the port never calls.
3. Prefill path (slice 1): TURNIP's offloaded prefill, traced at
   llama-7b's full width (d_model 4096, 32 heads, d_ff 11008, vocab
   32000) and cut to 8 layers at S=2048 in float16 as
   ``benchmarks/fig10_prefill.py`` cuts it, planned under fig10's
   tightest HBM budget scaled to the depth so that weights and
   activations are offloaded, and run by ``TurnipRuntime`` on the
   ByteArena in HBM with pinned host memory: one warm-up, then four
   dispatch policies and ``mode='fixed'``. Every run's logits are held
   against the port's plain evaluation (``eval_taskgraph``, no plan, plain
   kernels) and against each other.
4. Serving path (slice 2): llama-7b at full width and full depth (32
   layers, bfloat16, random weights drawn on the card from a seeded
   ``torch.Generator``) behind the continuous-batching ``Engine``: 12
   requests with prompts of 64-768 tokens (numpy seed 0) and 32 new
   tokens each, ``batch_buckets=(1, 4, 8)``, 64-token KV blocks mirrored
   to pinned host memory on the d2h copy stream, preemption every 8
   decode steps, so swapped requests reload over the h2d copy stream;
   once per reload policy. Three requests are held against the port's
   unbatched ``naive_generate`` on the card and the policies against each
   other (first-token logits within 2e-2 x max|logit|; tokens equal up to
   the first near tie, a step whose reference top-two logits differ by
   less than that).

Every path is driven with the kernels' launch counts set to 0 just before
it and read just after; each path fails unless each of its kernels was
launched, as many times as its shape says. ``--profile`` adds one more run
of each path (the prefill under policy ``fixed``, the serving path under
``critical-path``) under ``torch.profiler`` and prints the card's busy
time (the union of its kernel and copy intervals), its idle share of the
run's wall time, and the device time by kernel name.

The line before the last is ``{"kernels": [...]}``, one record per kernel
(``launches`` counted on the serving path); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                  # H100 SXM f32 outside the tensor cores
F16_FLOPS = 989e12                 # H100 SXM bf16/f16 tensor cores, dense
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

# flash attention: (label, (B, Sq, Skv, Hq, Hkv, Dh, causal, q_offset)).
# The first is the serving prefill's largest shape (the record's), the
# second the paper's prompt; then tests/test_kernels.py's sweep and two
# chunks of queries against a longer KV.
FLASH_MAIN = [("serving-prefill", (8, 768, 768, 32, 32, 128, True, 0)),
              ("paper-prompt", (1, 2048, 2048, 32, 32, 128, True, 0))]
FLASH_SWEEP = [("gqa", (2, 128, 128, 4, 2, 64, True, 0)),
               ("padded-tail", (1, 200, 200, 4, 4, 128, True, 0)),
               ("bidirectional", (2, 64, 256, 8, 2, 64, False, 0)),
               ("mqa-short-kv", (1, 256, 64, 2, 1, 64, True, 0)),
               ("q-offset-192", (1, 64, 256, 4, 2, 32, True, 192)),
               ("q-offset-512", (2, 256, 768, 32, 32, 128, True, 512))]

SERVE_REQUESTS = 12
SERVE_PROMPT = (64, 768)           # prompt lengths, uniform, numpy seed 0
SERVE_MAX_NEW = 32
SERVE_POLICIES = ("fixed", "random", "critical-path")
SERVE_CHECKED = 3                  # requests held against naive_generate
# first-token logits and near ties, relative to the largest reference
# logit: bf16 keeps ~3 significant digits, and cuBLAS picks other kernels
# for other batch shapes, so a batched and an unbatched run differ in the
# last bits of every product, compounded over 32 layers
SERVE_RTOL = 2e-2

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


def flash_bound_ms(B, Sq, Skv, Hq, Hkv, Dh, causal, q_offset,
                   itemsize) -> tuple[float, str]:
    """Least time for the attention: q, k, v read once and o written once;
    4 operations per (query, visible key, channel) (two products), the
    visible keys counted for these shapes (causal rows see
    min(Skv, i + q_offset + 1))."""
    if causal:
        visible = sum(min(Skv, i + q_offset + 1) for i in range(Sq))
    else:
        visible = Sq * Skv
    ops = 4 * B * Hq * visible * Dh
    peak = F32_FLOPS if itemsize == 4 else F16_FLOPS
    t_ops = ops / peak
    t_bytes = (2 * B * Sq * Hq + 2 * B * Skv * Hkv) * Dh * itemsize \
        / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_phase(torch, device) -> dict:
    """flash_attention against flash_attention_plain on the card at the
    main shapes (bfloat16, timed) and over the sweep in three dtypes.
    Returns the record of the serving prefill's shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)

    torch.backends.cuda.matmul.allow_tf32 = False    # plain f32 in full f32
    gen = torch.Generator(device=device).manual_seed(0)
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=device)
    cases = [(lbl, shp, torch.bfloat16, True) for lbl, shp in FLASH_MAIN]
    for lbl, shp in FLASH_MAIN + FLASH_SWEEP:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            if (lbl, dt) not in {(c[0], c[2]) for c in cases}:
                cases.append((lbl, shp, dt, False))
    main = None
    for lbl, (B, Sq, Skv, Hq, Hkv, Dh, causal, off), dt, timed in cases:
        q = torch.randn(B, Sq, Hq, Dh, generator=gen, device=device).to(dt)
        k = torch.randn(B, Skv, Hkv, Dh, generator=gen, device=device).to(dt)
        v = torch.randn(B, Skv, Hkv, Dh, generator=gen, device=device).to(dt)
        o = flash_attention(q, k, v, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        p = flash_attention_plain(q, k, v, causal=causal, q_offset=off)
        name = str(dt).removeprefix("torch.")
        atol, rtol = KERNEL_TOL[name]
        err = (o.float() - p.float()).abs()
        max_err = err.max().item()
        ok = bool((err <= atol + rtol * p.float().abs()).all())
        shape = f"{B}x{Sq}x{Skv} h{Hq}/{Hkv} d{Dh} causal={causal} " \
                f"q_offset={off}"
        line = (f"kernel flash_attention {lbl} {shape} {name}: max_abs_err "
                f"{max_err:.3g} (tol {atol:g} + {rtol:g}*|plain|) ok={ok}")
        if timed:
            k_ms = _median_ms(lambda: flash_attention(
                q, k, v, causal=causal, q_offset=off, out=o), torch, flush)
            p_ms = _median_ms(lambda: flash_attention_plain(
                q, k, v, causal=causal, q_offset=off), torch, flush)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = _median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), torch, flush)
            bound_ms, bound_by = flash_bound_ms(B, Sq, Skv, Hq, Hkv, Dh,
                                                causal, off, q.element_size())
            line += (f" kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms "
                     f"{lib_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})")
            if main is None:
                main = dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=lib_ms)
        print(line, flush=True)
        if not ok:
            raise AssertionError(f"flash_attention kernel disagrees with its "
                                 f"plain version at {lbl} {name}")
        del q, k, v, o, p, err
    # views at an unaligned stride: q, k, v sliced out of one fused
    # projection whose rows are 513 floats long, one float in
    x = torch.randn(2, 96, 8 * 64 + 1, generator=gen, device=device)
    heads = x[..., 1:].view(2, 96, 8, 64)
    q, k, v = heads[:, :, :4], heads[:, :, 4:6], heads[:, :, 6:]
    p = flash_attention_plain(q, k, v)
    err = (flash_attention(q, k, v) - p).abs()
    atol, rtol = KERNEL_TOL["float32"]
    ok = bool((err <= atol + rtol * p.abs()).all())
    print(f"kernel flash_attention strided-view 2x96 h4/2 d64 float32: "
          f"max_abs_err {err.max().item():.3g} ok={ok}", flush=True)
    if not ok:
        raise AssertionError("flash_attention disagrees on a strided view")
    del flush
    return main


def serving_traffic(vocab: int) -> list[list[int]]:
    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_REQUESTS)
    return [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def serve_config(policy: str):
    from repro_torch.serve import ServeConfig
    return ServeConfig(max_len=1024, batch_buckets=(1, 4, 8), block_size=64,
                       offload=True, hot_window=64, preempt_every=8,
                       reload_policy=policy)


def _margin(row: np.ndarray, vocab: int) -> tuple[float, float]:
    """(top-1 minus top-2 logit, max |logit|) of one row."""
    r = np.asarray(row[:vocab], np.float32)
    top2 = np.partition(r, -2)[-2:]
    return float(top2[1] - top2[0]), float(np.abs(r).max())


def agree_to_first_tie(ref: list[int], got: list[int],
                       margins: list[tuple[float, float]]) -> bool:
    """``got`` must equal ``ref`` up to the first near tie of the reference
    (a step whose top-two logits differ by less than SERVE_RTOL x max
    |logit|). Returns whether the two agree in full; raises otherwise."""
    ties = [j for j, (gap, mx) in enumerate(margins) if gap < SERVE_RTOL * mx]
    first_tie = ties[0] if ties else len(ref)
    diffs = [j for j, (a, b) in enumerate(zip(ref, got)) if a != b]
    if len(ref) != len(got):
        diffs.append(min(len(ref), len(got)))
    if diffs and diffs[0] < first_tie:
        raise AssertionError(f"tokens differ at step {diffs[0]} before the "
                             f"first near tie (step {first_tie}): "
                             f"{ref} vs {got}")
    return not diffs


def run_serving(torch, device, model, params, prompts, *,
                max_new: int = SERVE_MAX_NEW, checked: int = SERVE_CHECKED,
                profile: bool = False) -> dict:
    """The serving path under each reload policy, held against the port's
    naive_generate and across policies. Returns each kernel's launches
    over the policy runs."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.serve import Engine, naive_generate

    cfg = model.cfg
    vocab = cfg.vocab_size
    cuda = device.type == "cuda"
    t = time.perf_counter()
    with Engine(model, params, serve_config("fixed")) as warm:  # warm-up:
        warm.generate([prompts[0][:64]], max_new=2)   # cuBLAS handles, pins
    del warm
    _phase("serving warm-up", t)

    t = time.perf_counter()
    oracle, oracle_margins, oracle_first = [], [], []
    for i in range(checked):
        rows: list = []
        oracle.append(naive_generate(
            model, params, prompts[i], max_new=max_new, max_len=1024, rid=i,
            on_emit=lambda pos, row, rows=rows: rows.append(row.copy())))
        oracle_margins.append([_margin(r, vocab) for r in rows])
        oracle_first.append(rows[0])
    _phase("serving oracle (naive_generate)", t)

    launches = {"flash_attention": 0, "rmsnorm": 0}
    streams: dict[str, list[list[int]]] = {}
    margins_of: dict[str, dict[int, list]] = {}
    for policy in SERVE_POLICIES:
        margins: dict[int, list] = {i: [] for i in range(len(prompts))}
        first: dict[int, np.ndarray] = {}

        def on_emit(req, row, margins=margins, first=first):
            margins[req.rid].append(_margin(row, vocab))
            if req.rid < checked and req.rid not in first:
                first[req.rid] = row.copy()

        eng = Engine(model, params, serve_config(policy))
        eng.on_emit = on_emit
        gc.collect()               # the last run's engine and its 4 GiB cache
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0        # the serving path starts here
        rmsnorm.launches = 0
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new=max_new)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_fa, n_rms = flash_attention.launches, rmsnorm.launches
        peak = torch.cuda.max_memory_allocated() if cuda else None
        eng.close()
        st = eng.stats
        del eng
        forwards = st.prefill_calls + st.decode_steps
        first_err = max(
            float(np.abs(first[i] - oracle_first[i]).max()
                  / np.abs(oracle_first[i]).max()) for i in range(checked))
        full = sum(agree_to_first_tie(oracle[i], out[i], oracle_margins[i])
                   for i in range(checked))
        print(f"serve policy={policy}: wall_s {wall:.3f} prefill_time_s "
              f"{st.prefill_time:.3f} decode_time_s {st.decode_time:.3f} "
              f"stall_time_s {st.stall_time:.3f} decode_tok_s "
              f"{st.decode_tok_s:.2f} tokens {st.tokens} prefill_calls "
              f"{st.prefill_calls} decode_steps {st.decode_steps} swaps "
              f"{st.swaps} offload_bytes {st.offload_bytes} reload_bytes "
              f"{st.reload_bytes} peak_allocated_bytes {peak} "
              f"flash_attention_launches {n_fa} (= {cfg.n_layers} x "
              f"{st.prefill_calls} prefill calls) rmsnorm_launches {n_rms} "
              f"(= {2 * cfg.n_layers + 1} x {forwards} forwards) "
              f"first_token_logits_max_err/max|logit| {first_err:.3g} (tol "
              f"{SERVE_RTOL:g}) match_naive_in_full {full}/{checked}",
              flush=True)
        assert all(len(o) == max_new for o in out), "a request fell short"
        assert all(0 <= tok < vocab for o in out for tok in o)
        assert st.swaps > 0 and st.offload_bytes > 0 and st.reload_bytes > 0, \
            "no swap went over the copy streams"
        if cuda:                  # on the CPU the wrappers launch nothing
            assert n_fa == cfg.n_layers * st.prefill_calls > 0, \
                f"flash_attention launched {n_fa} times"
            assert n_rms == (2 * cfg.n_layers + 1) * forwards, \
                f"rmsnorm launched {n_rms} times"
        assert first_err <= SERVE_RTOL, "first-token logits disagree"
        launches["flash_attention"] += n_fa
        launches["rmsnorm"] += n_rms
        streams[policy] = out
        margins_of[policy] = margins
    ref_policy = SERVE_POLICIES[0]
    for policy in SERVE_POLICIES[1:]:
        full = sum(agree_to_first_tie(streams[ref_policy][i],
                                      streams[policy][i],
                                      margins_of[ref_policy][i])
                   for i in range(len(prompts)))
        print(f"serve policy={policy} vs {ref_policy}: match_in_full "
              f"{full}/{len(prompts)}", flush=True)
    if profile:
        def served() -> float:
            gc.collect()
            with Engine(model, params, serve_config("critical-path")) as eng:
                t0 = time.perf_counter()
                eng.generate(prompts, max_new=max_new)
                torch.cuda.synchronize()
                return time.perf_counter() - t0
        profile_run(torch, "serve policy=critical-path", served)
    return launches


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


def profile_run(torch, label: str, run) -> None:
    """One run under torch.profiler: the card's busy time and idle share
    over the run's wall time (``run`` returns it in seconds), and device
    time by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_s = run()
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
        print(f"profile {label}: no device events recorded (device busy "
              "time not measured)", flush=True)
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
    print(f"profile {label}: wall_ms {wall_s * 1e3:.2f} device_window_ms "
          f"{window_ms:.2f} device_busy_ms {busy_us / 1e3:.2f} "
          f"device_idle_share_of_wall {1 - busy_us / 1e3 / (wall_s * 1e3):.3f} "
          f"device_events {len(spans)}", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        print(f"profile {label}: {ms:9.3f} ms {n:5d}x {name[:100]}",
              flush=True)


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
        profile_run(torch, "prefill policy=fixed",
                    lambda: runtime("fixed", "nondet").run(inputs).makespan)
    return launches


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def build_serving(torch, device, arch=None):
    """llama-7b (or ``arch``) with random weights drawn on ``device`` from
    a seeded generator."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    model = build_model(arch if arch is not None else get_arch("llama-7b"),
                        device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    return model, params


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
    fa = flash_phase(torch, device)
    print("kernels: rmsnorm flash_attention", flush=True)
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
    _phase("prefill path", t)
    if launches["rmsnorm"] == 0:
        raise AssertionError("the prefill path launched no rmsnorm kernel")
    del inputs, tr, res

    t = time.perf_counter()
    model, params = build_serving(torch, device)
    prompts = serving_traffic(model.cfg.vocab_size)
    print(f"serving path: llama-7b, {model.cfg.n_layers} layers, bfloat16, "
          f"{sum(t.numel() for t in _leaves(params))} parameters "
          f"({sum(t.numel() * t.element_size() for t in _leaves(params))} B)"
          f"; {len(prompts)} requests, prompt tokens "
          f"{[len(p) for p in prompts]}, max_new {SERVE_MAX_NEW}", flush=True)
    _phase("serving model", t)
    t = time.perf_counter()
    served = run_serving(torch, device, model, params, prompts,
                         profile="--profile" in argv)
    _phase("serving path", t)

    records = [
        dict(name="rmsnorm", route="cuda",
             source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/kernel.py:13",
             launches=served["rmsnorm"], **rms),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:23",
             launches=served["flash_attention"], **fa)]
    _phase("total", t_all)
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
