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
   the tolerance stated per dtype (for attention outputs in 16 bits, two
   units in the last place plus a share of each row's rms:
   ``attention_limit``). Times are medians of CUDA-event times
   over repeated launches with the L2 cache flushed in between;
   ``bound`` is the least time the card could take (bytes over 3.35 TB/s
   or operations over the peak rate of their type, the larger).
   The rmsnorm kernel at [2048, 4096] float16 and the reference sweep;
   the flash-attention kernel at the serving prefill's shape (8 x 768,
   32 heads of 128, causal, bfloat16), at the paper's prompt (1 x 2048),
   on ``tests/test_kernels.py``'s sweep, on two ``q_offset > 0`` cases
   and on views at unaligned strides (16 bits: the kernel's element-load
   path), each in float32, bfloat16 and float16; the timed lines add the
   function's TFLOP/s and the share of the bound reached. The grouped-matmul kernel
   (``moe_gmm``) at moonshot-16b's expert shapes (D 2048, F 1408, 64
   experts): the balanced serving-prefill shape (64 groups of 576 rows),
   the same 8 x 768 tokens routed top-6 by a random moonshot router
   (ragged groups, the record's shape), a bucket-8 decode step (48 routed
   rows, most experts empty), groups of count 0 beside one that takes every
   row, the routed rows' down product (1408 -> 2048), and
   ``tests/test_kernels.py``'s ``TestMoEGMM`` sweep through the
   dense-grouped ``moe_gmm``, each in float32, bfloat16 and float16; every
   16-bit call at moonshot's shapes must run on the wgmma instance, and
   the decode step's host time per call is printed in bfloat16 and in
   float32, whose instance encodes no tensor map. The
   library time is one PyTorch call computing the same function
   (``F.rms_norm``, ``F.scaled_dot_product_attention``; for ``moe_gmm``
   ``torch.bmm`` on the balanced shape, which does the routed shape's
   operations), a yardstick the port never calls. The flash kernel also at
   zamba2-7b's shared-block shape (2 x 8192, 32 heads of 112, causal,
   bfloat16; its plain version over groups of 4 heads), timed beside
   ``F.scaled_dot_product_attention``. The recurrent scans at their main
   path's shapes in float32 and on ``tests/test_kernels.py``'s sweeps in
   float32 and bfloat16: ``ssd_scan`` at zamba2-7b's (2 x 8192, 112 heads
   of 64, state 64, chunk 128) with the test's input ranges, and once more
   on zamba2-7b's ranges, held with its plain version against a float64
   evaluation (``ssd_model_range`` says why); ``wkv6`` at rwkv6-7b's
   (2 x 8192, 64 heads of 64, chunk 32; log decays -exp(-6 + 2 N(0, 1))
   clipped at -20). No single PyTorch call computes either scan, so their
   library time is none.
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
5. MoE serving path (slice 3): the llama model is freed first. Then
   moonshot-v1-16b-a3b at full width and full depth (48 layers, d_model
   2048, 64 experts of 1408, top-6, vocab 163,840, bfloat16; random
   weights drawn on the card from a seeded ``torch.Generator``, the expert
   leaves directly in bfloat16) behind the same ``Engine``, traffic and
   configuration as phase 4, under each reload policy. Every MoE layer
   runs dropless through the grouped-matmul kernel, three launches per
   layer per forward. The rule, fixed before the path first ran on the
   card: three requests are held against the port's unbatched
   ``naive_generate``, which also records, for each generated token, the
   smallest relative gap (p_k - p_k+1) / p_k between the k-th and
   (k+1)-th routing probability of the row that produced it (the last
   prompt token for the first token, the decoded token after that) over
   the 48 layers. A *routing near tie* is a gap under ROUTE_RTOL = 1e-3:
   there a token can go to another expert in a batched run, and its
   output then moves by a gate's worth, not by an ulp. First-token logits
   within 2e-2 x max|logit| unless the first token is a routing near tie;
   tokens equal up to the first near tie of either kind (phase 4's logit
   ties, or routing). The three policies run the same batch shapes, so
   their 12 streams must agree in full, with no allowance.
6. Recurrent path (slice 4): the MoE model is freed first. Then
   rwkv6-7b (32 layers, d_model 4096, 64 heads of 64, d_ff 14336, vocab
   65,536) and zamba2-7b (81 Mamba2 layers in 13 groups of 6 and a tail
   of 3, d_model 3584, 112 SSM heads of 64, state 64; one shared
   attention+MLP block called before each group, 32 heads of 112) in
   turn, each at full width and depth in bfloat16 with random weights
   drawn on the card from a seeded ``torch.Generator`` (rwkv6-7b's
   zero-initialised leaves redrawn, see ``build_recurrent``). ``apply`` on
   2 x 8192 tokens (numpy seed 0): one warm-up, then 3 timed runs; the
   median, tokens/s, the peak allocated bytes and each kernel's launches,
   asserted per forward (rwkv6-7b: 32 wkv6 and 32 rmsnorm; zamba2-7b: 81
   ssd_scan, 108 rmsnorm and 13 flash attention; each scan call three
   device launches), and the bfloat16 noise
   floor (``apply`` on one token at two batch shapes). Then the
   reference's own check at full size, decode against apply, on the same
   model drawn in float32 (``decode_check``'s rule, and why float32): 150
   one-token ``decode_step``s of 2 rows against ``apply`` at every
   position.

7. Prefill under the compiled backend (slice 8): the same plan and
   policy runs with ``exec_backend="compiled"``: certified-static regions
   issued straight-line on CUDA streams, nondet regions handed to the
   inline executor or the fleet; each line adds the compiled counters.
   Logits within LOGIT_RTOL x max|plain| of the plain evaluation and of
   the interpreted run of the same policy; whether two compiled runs of
   one policy give the same bytes is printed.
8. LoRA fwd+bwd (slice 8, ROADMAP A11a): ``benchmarks/fig11_lora.py``'s
   cut with one device — llama-7b width, 3 layers, T = 1024 and 2048,
   float16, ``head_group=8``, ``q_block=max(512, T//2)``, 2 MLP slices,
   256-byte extents — planned under fig11's 2.5 GiB x 3/32 = 251,658,240 B,
   which offloads; inputs ``make_inputs(seed=0)``; the five policy runs
   under both backends. The rule, fixed before the phase first ran on the
   card: every adapter gradient finite and within LORA_GRAD_RTOL x
   max|plain| of the port's plain evaluation on the card, each gradient
   alone; a plain gradient that is not finite (float16 overflow) fails the
   phase. Each line prints makespan, busy and stall on the host's clock
   (``RunResult``'s spans), offload and reload bytes and rmsnorm launches
   (asserted: one per rmsnorm vertex of the forward and the re-traced
   backward, and one rmsnorm_bwd launch per ``rmsnorm_bwd`` vertex: the
   op runs the backward kernel on the card since slice 9); then
   ``rmsnorm_bwd``'s device time at its shapes (CUDA events).
9. The simulator against the card (ROADMAP A7): an H100 ``HardwareModel``
   measured here (pinned 256 MiB copies each way, a 4 KiB copy's
   latency, an on-card copy's rate, an empty launch, the prefill's largest
   matmul vertex), printed; then for the prefill and both LoRA plans, in
   ``nondet`` and ``fixed``, the simulated makespan beside the measured
   makespan of both backends and, with ``--profile``, beside the card's
   busy time in the profiled runs. Reported, not asserted.

10. Training (slice 9, ROADMAP A11b), after 9 and before the serving
   path (4), its models freed before serving builds its own. The rules
   were fixed here before the phase first ran on the card.
   a. Kernel lines. ``rmsnorm_bwd`` at the supervised run's shape
      (RMS_BWD_MAIN, [4 x 4096, 4096] bfloat16, with and without dγ;
      timed) and on the rmsnorm sweep in three dtypes: dx within
      KERNEL_TOL of ``rmsnorm_bwd_plain``, dγ (a sum over rows) within
      KERNEL_TOL plus 2e-6 of the sum of its terms' magnitudes. The flash
      backward at the training shapes (FLASH_BWD_MAIN: 4 and 1 x 4096, 32
      heads of 128, causal, bfloat16; timed) and on FLASH_BWD_SWEEP (the
      reference sweep, GQA 2 and 4, q_offset 192 and 512, head size 112)
      in float32, bfloat16 and float16: dQ, dK, dV within
      ``gradient_limit`` (two units in the last place of |plain| plus
      2^-8 of the row's rms, the forward's rule, plus 2^-12 of the
      tensor's rms for rows whose exact gradient vanishes) of
      ``flash_attention_bwd_plain``, which computes its own log-sum-exp
      and materialises the scores one KV head at a time; the forward's
      lse within 1e-5 of the plain one. Library times: ``F.rms_norm``
      forward + backward through autograd, and the backward of
      ``F.scaled_dot_product_attention`` through autograd (yardsticks the
      port never calls). Bounds as phase 2's, the backward's operations
      2.5 times the forward's (five products).
   b. Gradient check: llama-7b with LoRA, 32 layers, 1 x 4096 tokens
      (``SyntheticLMStream``, seed 0), base weights from
      ``torch.Generator(0)`` on the card, adapters from ``lora_init``
      (generator 1) with B redrawn as 0.01 N(0, 1) (with B = 0, dA is
      0). The oracle is the same step with ``layers.rmsnorm`` and
      ``layers.blockwise_attention`` swapped for their plain versions,
      forward and backward (``plain_layers``), under remat='full'. The
      rule is two-dtype (``grad_check``):
      - float32 (the same weights upcast): the kernels' step against the
        oracle, every adapter gradient finite and within TRAIN_F32_RTOL =
        1e-3 x max|plain| (2e-2 until its first two readings, 1.23e-5 and
        7.22e-6, set it), each alone, and the loss within
        TRAIN_LOSS_RTOL = 1e-3 (relative). The oracle is the float32
        truth of the next rule. This leg runs the kernels' float32
        instances; the bfloat16 ones are held tightly only by the kernel
        lines of a, and at the model level by the next rule.
      - bfloat16, the training dtype, under each of remat None, 'full',
        'dots' and 'offload': the loss within 1e-3 of the truth's; each
        adapter gradient's max error against the truth at most
        BF16_VS_PLAIN = 2 times the plain bfloat16 oracle's (one bf16
        rounding, 2^-8 of max|truth|, at least); the modes against
        remat=None by the 2e-2 rule, byte equality printed.
      The rule first fixed here held the bfloat16 step to the bfloat16
      oracle by 2e-2 alone. Its first run failed (layers/attn/wk/A:
      2.69e-5 > 0.02 x 9.77e-4), and the float32 truth shows why: the
      plain bfloat16 oracle itself is 0.022-0.040 of max|truth| away from
      it, leaf by leaf, while the kernels in float32 are within 1.3e-5 of
      it (PERF.md §6). At 32 layers of random bf16 weights no
      implementation meets 2e-2 against another, so the slice's bfloat16
      2e-2 criterion is not met as it was written; the float32 rule is
      where a kernel fault shows apart from rounding (ROADMAP C11 does
      the same for decode).
      Each line prints step time, peak allocated bytes, the offloaded and
      reloaded bytes ('offload', asserted: every layer's input once), and
      the launches of rmsnorm, rmsnorm_bwd, flash_attention and
      flash_attention_bwd, asserted (``expected_train_launches``): forward
      2L + 1 and L, the same again for the recomputed layers under every
      remat mode; backward 2L rmsnorm_bwd (the first layer's input norm has
      no gradient path: the embedding is frozen), one device launch each
      (no dγ: the gains are frozen), and L flash backward, two device
      launches each (the wrappers' ``kernel_launches``), every one of them
      on the 16-bit wgmma instance in bfloat16 (``launches_tc``).
   c. The supervised run, the slice's main path: ``repro_torch.launch.
      train``'s ``parse_args``, ``setup`` and ``run`` with ``--arch
      llama-7b --lora --remat offload --batch 4 --seq 4096 --steps 6
      --save-every 2``, checkpoints in a temporary directory. A step_fn
      wrapper raises once before step 5 (right after the checkpoint of
      step 4) and once before step 6: step 5 has run, and the wrapper
      first overwrites the live adapters and optimizer state with NaN, so
      only a restore of step 4 from the disk and a replay of step 5 give
      the right bytes. The Supervisor restores step 4 both times and goes
      on; the final adapters and optimizer state must be byte-equal to an
      uninterrupted 6-step run's. Losses printed per step run; launches
      and offloaded bytes asserted per step run. Then one loss-and-gradient step under
      remat='full' and one under 'offload' at the same shape: step time
      and peak allocated bytes. ``--profile`` adds a profiled 'offload'
      step: device time of the d2h and h2d copies, how many overlap a
      kernel, and the device operations that take the most time, each with
      its share of the step's device time (``profile_kernels``).
   d. Full-parameter step: llama-7b width, 4 of 32 layers, bfloat16,
      AdamW (lr 1e-3), 2 x 2048 tokens: every leaf's gradient by b's
      two-dtype rule (remat None), dγ through rmsnorm_bwd (2L + 1 calls a
      step, two device launches each), then 3 steps on that batch, the
      loss falling at each.

Placement (ROADMAP C2): every prefill and LoRA run asserts that the HBM it
allocates beyond what was allocated before it (peak
``max_memory_allocated`` minus the base) is at most the arena, the
returned outputs on the card and HBM_ALLOWANCE: one cuBLAS workspace
(4 MiB, set here by ``CUBLAS_WORKSPACE_CONFIG``) and one cuBLASLt
workspace (1 MiB) per (thread, compute stream) pair a run can form —
WS_PAIRS, the fleet's threads and the static walker on the 5 compute
streams, and the inline executor — and the ops' row scratch
(SCRATCH_BYTES). Each term is printed.

Every path is driven with the kernels' launch counts set to 0 just before
it and read just after; each path fails unless each of its kernels was
launched, as many times as its shape says, and (serving, MoE, zamba2-7b)
unless every flash launch went to the 16-bit tensor-core instance
(``launches_tc``; ``launches_scalar`` is the float32 one), and (MoE)
unless every moe_gmm launch went to the wgmma instance
(``launches_wgmma``; ``launches_mma`` is the instance for views TMA
cannot read). The build
phase prints each kernel function's registers and spills (``ptxas -v``). ``--profile`` adds one more run
of each path (the prefill under policy ``fixed`` in both modes,
interpreted and compiled, LoRA at T=2048 compiled in both modes, the
serving paths under ``critical-path``, one ``apply`` of each recurrent
model) under ``torch.profiler`` and prints the card's busy time (the union
of its kernel and copy intervals), its idle share of the run's wall time,
and the device time by kernel name; for a runtime run, beside the busy
time of its host spans.

``python3 chip_smoke.py --ab-prefill OTHER_ROOT`` runs nothing of the
above: it times the interpreted prefill of this checkout's port against
another checkout's (``ab_prefill``), for example the parent commit
unpacked with ``git archive`` under ``build/``. ``--ab-train OTHER_ROOT``
does the same for the training step of phase 10c (``ab_train``): step
times and the step's device time by kernel, the two checkouts in turns.

The line before the last is ``{"kernels": [...]}``, one record per kernel
(``launches`` of rmsnorm, flash attention and moe_gmm counted on the MoE
serving path, which runs all three, flash's and moe_gmm's also by
instance; of ssd_scan on zamba2-7b's timed ``apply`` runs and of wkv6 on
rwkv6-7b's, one per call, each with its device launches, three per call,
as ``kernel_launches``; of rmsnorm_bwd and flash_attention_bwd on the
supervised training run, each with its wrapper's device launches as
``kernel_launches``); the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# an ab_prefill or ab_train worker (``--ab-worker SRC ...``,
# ``--ab-train-worker SRC``) runs the port found in SRC
_WORKER = next((f for f in ("--ab-worker", "--ab-train-worker")
                if f in sys.argv), None)
SRC = (sys.argv[sys.argv.index(_WORKER) + 1] if _WORKER
       else os.path.join(ROOT, "src"))
sys.path.insert(0, SRC)

# one 4 MiB cuBLAS workspace per (handle, stream), fixed before torch first
# calls cuBLAS, so the placement bound can count them (cuBLASLt adds 1 MiB
# per pair where it runs); an ab_prefill worker may keep cuBLAS's default
CUBLAS_WS_BYTES = 4 * 2**20
CUBLASLT_WS_BYTES = 2**20
if "--default-workspace" not in sys.argv:
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = f":{CUBLAS_WS_BYTES // 1024}:1"
N_STREAMS = 5                      # TurnipRuntime's compute streams
# (thread, compute stream) pairs a run can form: the fleet's threads, the
# static walker's one thread on the N_STREAMS streams, the inline executor
WS_PAIRS = 2 * N_STREAMS + 1
SCRATCH_BYTES = 16 * 2**20         # the ops' row scratch, all streams
HBM_ALLOWANCE = WS_PAIRS * (CUBLAS_WS_BYTES + CUBLASLT_WS_BYTES) + \
    SCRATCH_BYTES

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                  # H100 SXM f32 outside the tensor cores
F16_FLOPS = 989e12                 # H100 SXM bf16/f16 tensor cores, dense
# kernel-vs-plain tolerance per dtype: |k - p| <= atol + rtol * |p|. The
# two differ only in the f32 summation order and the final rounding to
# the storage type, so the tolerance is about one unit in the last place.
KERNEL_TOL = {"float32": (2e-5, 2e-4), "float16": (2e-3, 2e-3),
              "bfloat16": (3e-2, 3e-2)}
# the grouped matmul's float32 products reduce over D = 2048: the kernel
# and cuBLAS add the D products in other orders, and each order's rounding
# grows with the partial sums (~sqrt(D) for unit inputs) over D terms, so
# the absolute part of its float32 tolerance is 1e-6 x D (2.0e-3 at 2048,
# ~1e-4 at the sweep's widths); the 16-bit types keep KERNEL_TOL, set by
# their final rounding
GMM_F32_ATOL_PER_D = 1e-6


def gmm_tol(name: str, d: int) -> tuple[float, float]:
    atol, rtol = KERNEL_TOL[name]
    if name == "float32":
        atol = max(atol, GMM_F32_ATOL_PER_D * d)
    return atol, rtol


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
# a routing near tie: the reference's k-th and (k+1)-th routing
# probabilities within this fraction of the k-th (see phase 5)
ROUTE_RTOL = 1e-3
MOE_ARCH = "moonshot-v1-16b-a3b"
GMM_PREFILL_TOKENS = 8 * 768       # the serving prefill's largest call
GMM_DECODE_TOKENS = 8              # a bucket-8 decode step
GMM_SWEEP = [(4, 100, 96, 130), (2, 64, 64, 64), (8, 16, 48, 32)]
GMM_HOST_CALLS = 200               # decode-step calls timed on the host

MAIN_LAYERS = 8
MAIN_SEQ = 2048
POLICY_RUNS = [("random", "nondet"), ("fixed", "nondet"),
               ("critical-path", "nondet"), ("transfer-first", "nondet"),
               ("fixed", "fixed")]
EXEC_BACKENDS = ("interpreted", "compiled")
TWICE_POLICY = ("critical-path", "nondet")   # run twice compiled: same bytes?

# LoRA fwd+bwd (fig11's cut, one device)
LORA_TOKENS = (1024, 2048)
LORA_LAYERS = 3
LORA_BUDGET_GIB = 2.5
# adapter gradients against the plain evaluation, each relative to its own
# largest plain value: float16 storage between every vertex (~3 digits),
# the streaming sums' order, over 3 layers forward and backward
LORA_GRAD_RTOL = 2e-2

# the recurrent scans: tests/test_kernels.py's tolerances in float32, and
# KERNEL_TOL's in bfloat16 (one rounding of an f32 sum)
SCAN_TOL = {"ssd_scan": {"float32": (5e-4, 5e-4), "bfloat16": (3e-2, 3e-2)},
            "wkv6": {"float32": (1e-3, 1e-3), "bfloat16": (3e-2, 3e-2)}}
# main-path shapes: zamba2-7b's Mamba layers (B, S, H, P, N, chunk) and
# rwkv6-7b's time mix (B, S, H, P, chunk) at the recurrent path's 2 x 8192
SSD_MAIN = (2, 8192, 112, 64, 64, 128)
WKV_MAIN = (2, 8192, 64, 64, 32)
# tests/test_kernels.py's TestSSDScan and TestWKV6 sweeps (S padding
# included)
SSD_SWEEP = [(2, 100, 3, 32, 16, 32), (1, 64, 2, 64, 64, 16),
             (2, 33, 1, 16, 8, 64)]
WKV_SWEEP = [(2, 100, 3, 32, 25), (1, 31, 2, 64, 8), (2, 64, 1, 16, 64)]
# zamba2-7b's shared attention block at the recurrent path's shape:
# (B, S, heads, head size 3584 / 32), causal, bfloat16
FLASH_112 = (2, 8192, 32, 112)
FLASH_112_PLAIN_GROUP = 4      # heads per plain call ([B,4,S,S] f32 scores)

RECURRENT_ARCHS = ("rwkv6-7b", "zamba2-7b")
RECURRENT_TOKENS = (2, 8192)   # apply's batch, numpy seed 0
RECURRENT_TIMED = 3            # timed apply runs after one warm-up
DECODE_CHECK = (2, 150)        # rows x tokens: 150 is no multiple of 128/32
DECODE_MAX_LEN = 160

# training (phase 10): llama-7b at full width and depth, bfloat16
TRAIN_ARCH = "llama-7b"
RMS_BWD_MAIN = (4 * 4096, 4096)        # the supervised run's norms, bf16
# (B, Sq, Skv, Hq, Hkv, Dh, causal, q_offset): the supervised run's and
# the gradient check's attention, then the reference sweep (FLASH_SWEEP:
# GQA 2, q_offset 192 and 512), GQA 4 and head size 112
FLASH_BWD_MAIN = [("train-4x4096", (4, 4096, 4096, 32, 32, 128, True, 0)),
                  ("train-1x4096", (1, 4096, 4096, 32, 32, 128, True, 0))]
FLASH_BWD_SWEEP = FLASH_SWEEP + [
    ("gqa-4", (1, 512, 512, 32, 8, 128, True, 0)),
    ("head-112", (1, 100, 130, 4, 4, 112, True, 30))]
GRAD_CHECK = (1, 4096)                 # batch x sequence of the check
REMAT_ORDER = (None, "full", "dots", "offload")
LORA_B_SCALE = 0.01                    # the check's B ~ 0.01 N(0, 1)
# the training loss against the plain oracle, relative: bf16 activations
# through 32 layers, two orders of summation
TRAIN_LOSS_RTOL = 1e-3
# float32 gradients against the plain float32 oracle, relative to each
# leaf's max|plain|: readings 1.23e-5 (32 LoRA layers) and 7.22e-6 (4
# full-parameter layers) on an H100; a kernel a few tenths of a percent
# off fails it
TRAIN_F32_RTOL = 1e-3
# bfloat16 gradients: each leaf's max error against the float32 truth at
# most this many times the plain bfloat16 oracle's (phase 10b)
BF16_VS_PLAIN = 2.0
BF16_ULP = 2.0 ** -8          # its floor: one bfloat16 rounding
# faults: before step 5, right after the checkpoint of step 4; before
# step 6, when step 5 has run and the live state (poisoned first) is no
# checkpoint's, so that only a restore from the disk and a replay of step
# 5 give the uninterrupted run's bytes
SUPERVISED = dict(batch=4, seq=4096, steps=6, save_every=2, faults=(5, 6))
FULL_PARAM = dict(layers=4, batch=2, seq=2048, steps=3, lr=1e-3)


def reset_launches(fn) -> None:
    """Zero a wrapper's launch counts: ``launches``; by instance, flash
    attention's ``launches_tc`` and ``launches_scalar``, moe_gmm's
    ``launches_wgmma``, ``launches_mma`` and ``launches_scalar``; and
    the scans' device launches, ``kernel_launches``."""
    for attr in ("launches", "launches_tc", "launches_scalar",
                 "launches_wgmma", "launches_mma", "kernel_launches"):
        if hasattr(fn, attr):
            setattr(fn, attr, 0)


def assert_gmm_on_wgmma(gmm) -> None:
    """Every moe_gmm launch since the last reset went to the wgmma/TMA
    instance."""
    assert gmm.launches_wgmma == gmm.launches, \
        (f"moe_gmm: {gmm.launches} launches, {gmm.launches_wgmma} on wgmma, "
         f"{gmm.launches_mma} on mma.sync, {gmm.launches_scalar} scalar")


def rate(ops: int, k_ms: float, bound_ms: float) -> str:
    """A timed kernel's TFLOP/s of the function's operations and the share
    of its bound it reaches."""
    return (f"tflops {ops / k_ms / 1e9:.1f} bound_share "
            f"{bound_ms / k_ms:.4f}")


def assert_flash_on_tensor_cores(fa) -> None:
    """Every flash launch since the last reset went to the 16-bit wgmma
    instance."""
    assert fa.launches_tc == fa.launches and fa.launches_scalar == 0, \
        (f"flash_attention: {fa.launches} launches, {fa.launches_tc} on the "
         f"tensor cores, {fa.launches_scalar} scalar")


def ptxas_lines(log: str) -> list[str]:
    """Each kernel function's ptxas register and spill line, after its
    (mangled) name."""
    out, fn, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and fn is not None:
            out.append(f"{fn}: {line.split(':', 1)[1].strip()}; {spills}")
    return out


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


def flash_ops(B, Sq, Skv, Hq, Dh, causal, q_offset) -> int:
    """The attention's operations: 4 per (query, visible key, channel)
    (two products), the visible keys counted for these shapes (causal rows
    see min(Skv, i + q_offset + 1)). The bfloat16 kernel's second P.V
    product (P split into hi + lo) is not counted: it is the kernel's cost,
    not the function's."""
    if causal:
        visible = sum(min(Skv, i + q_offset + 1) for i in range(Sq))
    else:
        visible = Sq * Skv
    return 4 * B * Hq * visible * Dh


def flash_bound_ms(B, Sq, Skv, Hq, Hkv, Dh, causal, q_offset,
                   itemsize) -> tuple[float, str]:
    """Least time for the attention: q, k, v read once and o written once,
    and flash_ops at the peak rate of the type."""
    ops = flash_ops(B, Sq, Skv, Hq, Dh, causal, q_offset)
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
        attention_limit, flash_attention, flash_attention_plain)

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
        err = (o.float() - p.float()).abs()
        max_err = err.max().item()
        ratio = (err / attention_limit(p, name)).max().item()
        ok = ratio <= 1.0
        shape = f"{B}x{Sq}x{Skv} h{Hq}/{Hkv} d{Dh} causal={causal} " \
                f"q_offset={off}"
        line = (f"kernel flash_attention {lbl} {shape} {name}: max_abs_err "
                f"{max_err:.3g} max err/limit {ratio:.3g} (attention_limit) "
                f"ok={ok}")
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
                     f"{lib_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) "
                     + rate(flash_ops(B, Sq, Skv, Hq, Dh, causal, off),
                                  k_ms, bound_ms))
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
    # projection whose rows are 513 elements long, one element in (in 16
    # bits the wgmma kernel's element-load path)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dt).removeprefix("torch.")
        x = torch.randn(2, 96, 8 * 64 + 1, generator=gen, device=device
                        ).to(dt)
        heads = x[..., 1:].view(2, 96, 8, 64)
        q, k, v = heads[:, :, :4], heads[:, :, 4:6], heads[:, :, 6:]
        p = flash_attention_plain(q, k, v)
        err = (flash_attention(q, k, v).float() - p.float()).abs()
        ratio = (err / attention_limit(p, name)).max().item()
        print(f"kernel flash_attention strided-view 2x96 h4/2 d64 {name}: "
              f"max_abs_err {err.max().item():.3g} max err/limit "
              f"{ratio:.3g} (attention_limit) ok={ratio <= 1.0}", flush=True)
        if ratio > 1.0:
            raise AssertionError(f"flash_attention disagrees on a strided "
                                 f"view in {name}")
    del flush
    return main


def gmm_bound_ms(rows: int, d: int, f: int, hit: int,
                 itemsize: int) -> tuple[float, str]:
    """Least time for a grouped matmul: the rows of x read once, the output
    written once, the weights of the ``hit`` experts that received a row
    read once; 2 operations per (row, d, f)."""
    t_bytes = (rows * d + rows * f + hit * d * f) * itemsize / HBM_BYTES_PER_S
    t_ops = 2 * rows * d * f / (F32_FLOPS if itemsize == 4 else F16_FLOPS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gmm_phase(torch, device) -> dict:
    """moe_gmm against its plain versions on the card at moonshot-16b's
    expert shapes and on the reference sweep, in three dtypes; the main
    shapes timed in bfloat16: the balanced and the routed gate product
    (2048 -> 1408), the routed down product (1408 -> 2048) and a bucket-8
    decode step. Every 16-bit call at these shapes must go to the wgmma
    instance. Returns the record of the routed gate product, with the down
    product's and the decode step's times and bounds beside it, and the
    host's time to issue one decode-step call: ``host_us`` in bfloat16 (the
    wrapper and the encoding of the call's two tensor maps) and
    ``host_us_scalar`` in float32 (the same wrapper, no tensor map)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.moe_gmm.ops import (
        grouped_matmul, grouped_matmul_plain, moe_gmm, moe_gmm_plain)
    from repro_torch.models.layers import moe_route

    torch.backends.cuda.matmul.allow_tf32 = False    # plain f32 in full f32
    cfg = get_arch(MOE_ARCH)
    D, Fe, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    gen = torch.Generator(device=device).manual_seed(0)
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=device)
    router = torch.randn(D, E, generator=gen, device=device) / math.sqrt(D)

    def routed(n_tokens):
        """x rows and groups from top-k routing of random tokens."""
        x = torch.randn(n_tokens, D, generator=gen, device=device)
        probs = torch.softmax(x @ router, dim=-1)
        _, _, perm, offsets, counts = moe_route(probs, k)
        return x[perm // k], offsets.int(), counts.int()

    cases = []   # (label, x [R, K] f32, offsets, counts or None)
    C = GMM_PREFILL_TOKENS * k // E
    cases.append(("prefill-balanced", torch.randn(
        E * C, D, generator=gen, device=device), None, None))
    x_routed, off_routed, cnt_routed = routed(GMM_PREFILL_TOKENS)
    cases.append(("prefill-routed", x_routed, off_routed, cnt_routed))
    cases.append(("decode-routed", *routed(GMM_DECODE_TOKENS)))
    zero = torch.zeros(E, dtype=torch.int32, device=device)
    full = zero.clone()
    full[E // 2] = 300                  # one group takes every row
    cases.append(("count-0-groups", torch.randn(
        300, D, generator=gen, device=device), zero.clone(), full))
    w_gate = torch.randn(E, D, Fe, generator=gen, device=device)
    cases = [(*case, w_gate) for case in cases]
    # the down product of the routed rows: [R, 1408] x [E, 1408, 2048]
    cases.append(("prefill-routed-down", torch.randn(
        x_routed.shape[0], Fe, generator=gen, device=device), off_routed,
        cnt_routed, torch.randn(E, Fe, D, generator=gen, device=device)))
    main, timed, host_us = None, {}, {}
    for label, x32, offsets, counts, w32 in cases:
        for dt in (torch.bfloat16, torch.float32, torch.float16):
            x, w = x32.to(dt), w32.to(dt)
            K, N = w.shape[1], w.shape[2]
            name = str(dt).removeprefix("torch.")
            wg0 = moe_gmm.launches_wgmma
            if counts is None:              # the dense-grouped interface
                x3 = x.view(E, C, K)
                y = moe_gmm(x3, w)
                torch.cuda.synchronize()
                p = moe_gmm_plain(x3, w)
                hit = E
            else:
                y = grouped_matmul(x, w, offsets, counts)
                torch.cuda.synchronize()
                p = grouped_matmul_plain(x, w, offsets, counts)
                hit = int((counts > 0).sum())
            if device.type == "cuda" and dt != torch.float32:
                assert moe_gmm.launches_wgmma == wg0 + 1, \
                    f"moe_gmm {label} {name} did not run on wgmma"
            atol, rtol = gmm_tol(name, K)
            err = (y.float() - p.float()).abs()
            max_err = err.max().item()
            ok = bool((err <= atol + rtol * p.float().abs()).all())
            rows = x.shape[0]
            line = (f"kernel moe_gmm {label} rows={rows} D={K} F={N} "
                    f"experts_hit={hit}/{E} {name}: max_abs_err {max_err:.3g} "
                    f"(tol {atol:g} + {rtol:g}*|plain|) ok={ok}")
            if dt == torch.bfloat16 and label != "count-0-groups":
                if counts is None:
                    k_ms = _median_ms(lambda: moe_gmm(x3, w), torch, flush)
                    p_ms = _median_ms(lambda: moe_gmm_plain(x3, w), torch,
                                      flush)
                    lib_ms = _median_ms(lambda: torch.bmm(x3, w), torch,
                                        flush)
                    bmm_ms = lib_ms
                else:
                    k_ms = _median_ms(lambda: grouped_matmul(
                        x, w, offsets, counts, out=y), torch, flush)
                    p_ms = _median_ms(lambda: grouped_matmul_plain(
                        x, w, offsets, counts), torch, flush)
                    lib_ms = None
                bound_ms, bound_by = gmm_bound_ms(rows, K, N, hit,
                                                  x.element_size())
                line += (f" kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
                         f"library_ms {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} "
                         f"bound_ms {bound_ms:.4f} ({bound_by}) "
                         + rate(2 * rows * K * N, k_ms, bound_ms))
                timed[label] = (k_ms, bound_ms)
                if label == "prefill-routed":
                    # torch.bmm on the balanced shape: the same operations
                    main = dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=bmm_ms)
            if label == "decode-routed" and dt != torch.float16:
                # the same wrapper; the f32 instance encodes no tensor map
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(GMM_HOST_CALLS):
                    grouped_matmul(x, w, offsets, counts, out=y)
                host_us[name] = ((time.perf_counter() - t0)
                                 / GMM_HOST_CALLS * 1e6)
                torch.cuda.synchronize()
                line += f" host_us_per_call {host_us[name]:.1f}"
            print(line, flush=True)
            if not ok:
                raise AssertionError(f"moe_gmm kernel disagrees with its "
                                     f"plain version at {label} {name}")
            del x, w, y, p, err
    main.update(down_ms=timed["prefill-routed-down"][0],
                down_bound_ms=timed["prefill-routed-down"][1],
                decode_ms=timed["decode-routed"][0],
                decode_bound_ms=timed["decode-routed"][1],
                host_us=host_us["bfloat16"],
                host_us_scalar=host_us["float32"])
    for E2, C2, D2, F2 in GMM_SWEEP:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            x = torch.randn(E2, C2, D2, generator=gen, device=device).to(dt)
            w = torch.randn(E2, D2, F2, generator=gen, device=device).to(dt)
            name = str(dt).removeprefix("torch.")
            y = moe_gmm(x, w)
            torch.cuda.synchronize()
            p = moe_gmm_plain(x, w)
            atol, rtol = gmm_tol(name, D2)
            err = (y.float() - p.float()).abs()
            ok = bool((err <= atol + rtol * p.float().abs()).all())
            print(f"kernel moe_gmm sweep E={E2} C={C2} D={D2} F={F2} {name}: "
                  f"max_abs_err {err.max().item():.3g} ok={ok}", flush=True)
            if not ok:
                raise AssertionError(f"moe_gmm kernel disagrees with its "
                                     f"plain version at {(E2, C2, D2, F2)} "
                                     f"{name}")
    del flush, w_gate, cases, x_routed
    return main


def ssd_ops(B, S, H, P, N, chunk) -> int:
    """The SSD scan's operations: per chunk of n rows, per b, the lower
    triangle's C.B products (n(n+1)/2 x N multiply-adds: B and C are
    shared by the heads, so C.B is needed once for all of them), and per
    (b, h) its weights (an exponential and two products each), its weighted
    sum of x (x P), the incoming-state term and the state update (n x P x N
    multiply-adds each): two operations a multiply-add, one an exponential
    or a product."""
    ops = 0
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        tri = n * (n + 1) // 2
        ops += B * 2 * tri * N \
            + B * H * (2 * tri * P + 3 * tri + 2 * 2 * n * P * N)
    return ops


def ssd_bound_ms(B, S, H, P, N, chunk, itemsize) -> tuple[float, str]:
    """Least time for the SSD scan: x, dt, B, C read once and y written
    once, and ``ssd_ops`` at the f32 rate."""
    t_ops = ssd_ops(B, S, H, P, N, chunk) / F32_FLOPS
    t_bytes = (2 * B * S * H * P + B * S * H + 2 * B * S * N) * itemsize \
        / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def wkv6_ops(B, S, H, P, chunk) -> int:
    """WKV6's operations: per chunk of n rows, per (b, h), the strict lower
    triangle's A terms (n(n-1)/2 x P, each two products, a sum and an
    exponential), A v (n(n-1)/2 x P multiply-adds), the bonus (5 n P), the
    incoming-state term and the state update (n x P x P multiply-adds
    each, and 2 n P for their decay factors)."""
    ops = 0
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        tri = n * (n - 1) // 2
        ops += 4 * tri * P + 2 * tri * P + 5 * n * P \
            + 2 * 2 * n * P * P + 2 * 2 * n * P
    return ops * B * H


def wkv6_bound_ms(B, S, H, P, chunk, itemsize) -> tuple[float, str]:
    """Least time for WKV6: r, k, v, lw read once and y written once, and
    ``wkv6_ops`` at the f32 rate."""
    t_ops = wkv6_ops(B, S, H, P, chunk) / F32_FLOPS
    t_bytes = 5 * B * S * H * P * itemsize / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _check_close(label: str, got, want, tol) -> float:
    """Max |got - want|; raises unless |got - want| <= atol + rtol|want|
    everywhere."""
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    max_err = err.max().item()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    print(f"kernel {label}: max_abs_err {max_err:.3g} (tol {atol:g} + "
          f"{rtol:g}*|plain|) ok={ok}", flush=True)
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version at "
                             f"{label}")
    return max_err


def scan_phase(torch, device) -> dict:
    """ssd_scan and wkv6 against their plain versions on the card: at the
    main path's shapes (float32, timed, inputs from the models' ranges) and
    on the reference sweeps in float32 and bfloat16. Returns each kernel's
    record at its main shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.rwkv6.ops import wkv6, wkv6_plain
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain

    gen = torch.Generator(device=device).manual_seed(0)
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def ssd_inputs(B, S, H, P, N, dt, model_range=False):
        x, Bm, Cm = randn(B, S, H, P), randn(B, S, N), randn(B, S, N)
        if model_range:  # zamba2-7b's: softplus'd dt, A = -linspace(1, 16)
            d = F.softplus(randn(B, S, H))
            A = -torch.linspace(1.0, 16.0, H, device=device)
        else:            # tests/test_kernels.py's, whose tolerance this is
            d, A = randn(B, S, H).abs(), -randn(H).abs()
        return x.to(dt), d.to(dt), A, Bm.to(dt), Cm.to(dt)

    def wkv_inputs(B, S, H, P, dt, model_range=False):
        r, k, v = randn(B, S, H, P), randn(B, S, H, P), randn(B, S, H, P)
        # the model's log decay: -exp(w_base -6 + its LoRA's term)
        lw = -torch.exp(randn(B, S, H, P) * (2.0 if model_range else 1.0)
                        - (6.0 if model_range else 0.0))
        return (r.to(dt), k.to(dt), v.to(dt), lw.clamp(-20, 0).to(dt),
                randn(H, P))

    records = {}
    for name, fn, plain, make, main_shape, sweep, bound, count in (
            ("ssd_scan", ssd_scan, ssd_scan_plain, ssd_inputs, SSD_MAIN,
             SSD_SWEEP, ssd_bound_ms, ssd_ops),
            ("wkv6", wkv6, wkv6_plain, wkv_inputs, WKV_MAIN, WKV_SWEEP,
             wkv6_bound_ms, wkv6_ops)):
        cases = [(main_shape, torch.float32, True)] + [
            (shp, dt, False) for shp in sweep
            for dt in (torch.float32, torch.bfloat16)]
        for shape, dt, main in cases:
            *dims, chunk = shape
            # the main shape of wkv6 takes the model's decay range; that of
            # ssd_scan the test's ranges (see ssd_model_range)
            args = make(*dims, dt, main and name == "wkv6")
            reset_launches(fn)
            y = fn(*args, chunk=chunk)
            torch.cuda.synchronize()
            if device.type == "cuda":       # both: 3 device launches a call
                assert (fn.launches, fn.kernel_launches) == (1, 3), \
                    (name, fn.launches, fn.kernel_launches)
            p = plain(*args, chunk=chunk)
            dname = str(dt).removeprefix("torch.")
            label = (f"{name} {'main' if main else 'sweep'} "
                     f"{'x'.join(map(str, shape))} {dname}")
            max_err = _check_close(label, y, p, SCAN_TOL[name][dname])
            if main:
                k_ms = _median_ms(lambda: fn(*args, chunk=chunk), torch,
                                  flush)
                p_ms = _median_ms(lambda: plain(*args, chunk=chunk), torch,
                                  flush, reps=5)
                bound_ms, bound_by = bound(*shape, args[0].element_size())
                print(f"kernel {label}: kernel_ms {k_ms:.4f} plain_ms "
                      f"{p_ms:.4f} library_ms None bound_ms {bound_ms:.4f} "
                      f"({bound_by}) " + rate(count(*shape), k_ms, bound_ms),
                      flush=True)
                records[name] = dict(max_abs_err=max_err, ms=k_ms,
                                     plain_ms=p_ms, bound_ms=bound_ms,
                                     bound_by=bound_by, library_ms=None)
            del args, y, p
    ssd_model_range(torch, ssd_inputs(*SSD_MAIN[:5], torch.float32, True),
                    SSD_MAIN[5])
    del flush
    return records


def ssd_model_range(torch, args, chunk: int) -> None:
    """ssd_scan on zamba2-7b's input ranges (A down to -16, softplus'd
    dt), where seg = cumsum(dt * A) reaches ~-10^3 within a chunk and the
    f32 rounding of seg alone moves exp(seg_t - seg_s) by ~1e-4 relative:
    there any two f32 evaluations that sum in other orders differ by more
    than the float32 tolerance above, which tests/test_kernels.py set on
    |A|, dt ~ |N(0, 1)|. So the kernel and the plain version are each held
    against a float64 evaluation of the model's own recurrence
    (models/ssm.py::_ssd_chunked), and the kernel's error may be at most
    twice the plain version's."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
    from repro_torch.models.ssm import _ssd_chunked

    y = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    p = ssd_scan_plain(*args, chunk=chunk)
    B, _, H, P = args[0].shape
    h0 = torch.zeros(B, H, P, args[3].shape[-1], dtype=torch.float64,
                     device=args[0].device)
    exact, _ = _ssd_chunked(*(t.double() for t in args), chunk=chunk, h0=h0)
    err_k = (y.double() - exact).abs().max().item()
    err_p = (p.double() - exact).abs().max().item()
    vs_plain = (y - p).abs().max().item()
    ok = err_k <= 2 * err_p
    print(f"kernel ssd_scan model-range {'x'.join(map(str, SSD_MAIN))} "
          f"float32: max_abs_err vs float64 {err_k:.3g}, plain's {err_p:.3g} "
          f"(kernel <= 2 x plain), kernel vs plain {vs_plain:.3g}, "
          f"max|y| {exact.abs().max().item():.4g} ok={ok}", flush=True)
    if not ok:
        raise AssertionError("ssd_scan is less accurate than its plain "
                             "version on zamba2-7b's input ranges")


def flash_112_phase(torch, device) -> None:
    """The flash kernel at zamba2-7b's shared-block shape (head size 112),
    bfloat16, against its plain version (run over groups of
    FLASH_112_PLAIN_GROUP heads: the whole [B, H, S, S] f32 score tensor
    would take 17 GB), timed beside F.scaled_dot_product_attention."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        attention_limit, flash_attention, flash_attention_plain)

    B, S, H, Dh = FLASH_112
    gen = torch.Generator(device=device).manual_seed(0)
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=device)
    q, k, v = (torch.randn(B, S, H, Dh, generator=gen, device=device
                           ).to(torch.bfloat16) for _ in range(3))
    o = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    G = FLASH_112_PLAIN_GROUP

    def plain():
        return torch.cat([flash_attention_plain(
            q[:, :, h:h + G], k[:, :, h:h + G], v[:, :, h:h + G])
            for h in range(0, H, G)], dim=2)
    p = plain()
    err = (o.float() - p.float()).abs()
    ratio = (err / attention_limit(p, "bfloat16")).max().item()
    # the last 1024 rows alone: their outputs are the smallest
    late = (err[:, -1024:].square().mean(-1).sqrt()
            / p[:, -1024:].float().square().mean(-1).sqrt()).max().item()
    ok = ratio <= 1.0
    print(f"kernel flash_attention zamba-shared {B}x{S} h{H} d{Dh} causal "
          f"bfloat16: max_abs_err {err.max().item():.3g} max err/limit "
          f"{ratio:.3g} (attention_limit) rows {S - 1024}-{S - 1} rms "
          f"err/rms {late:.3g} ok={ok}", flush=True)
    if not ok:
        raise AssertionError("flash_attention disagrees with its plain "
                             "version at zamba2-7b's shared-block shape")
    del p, err
    k_ms = _median_ms(lambda: flash_attention(q, k, v, causal=True, out=o),
                      torch, flush, reps=5)
    p_ms = _median_ms(plain, torch, flush, reps=3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = _median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), torch, flush)
    bound_ms, bound_by = flash_bound_ms(B, S, S, H, H, Dh, True, 0, 2)
    print(f"kernel flash_attention zamba-shared {B}x{S} h{H} d{Dh} causal "
          f"bfloat16: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms "
          f"{lib_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) "
          + rate(flash_ops(B, S, S, H, Dh, True, 0), k_ms, bound_ms),
          flush=True)
    del q, k, v, o, flush


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
                       margins: list[tuple[float, float]],
                       route_ties: list[int] = ()) -> bool:
    """``got`` must equal ``ref`` up to the first near tie of the reference:
    a step whose top-two logits differ by less than SERVE_RTOL x max
    |logit|, or a step in ``route_ties`` (a routing near tie). Returns
    whether the two agree in full; raises otherwise."""
    ties = [j for j, (gap, mx) in enumerate(margins) if gap < SERVE_RTOL * mx]
    first_tie = min(ties + list(route_ties) + [len(ref)])
    diffs = [j for j, (a, b) in enumerate(zip(ref, got)) if a != b]
    if len(ref) != len(got):
        diffs.append(min(len(ref), len(got)))
    if diffs and diffs[0] < first_tie:
        raise AssertionError(f"tokens differ at step {diffs[0]} before the "
                             f"first near tie (step {first_tie}): "
                             f"{ref} vs {got}")
    return not diffs


class RouteGaps:
    """While active, every MoE block call records the smallest relative gap
    (p_k - p_k+1) / p_k between the k-th and (k+1)-th routing probability
    of its last token row: in an unbatched run, the row whose logits give
    the next token. ``per_forward`` groups the calls by forward (one call
    per layer) and keeps the smallest gap of each."""

    def __init__(self, torch, n_layers: int):
        from repro_torch.models import layers
        self.torch, self.layers, self.n_layers = torch, layers, n_layers
        self.gaps: list[float] = []

    def __enter__(self):
        torch, orig = self.torch, self.layers.moe_block
        self._orig = orig

        def observed(p, x, *, n_experts, top_k, capacity_factor=1.25):
            probs = torch.softmax(x[:, -1].float() @ p["router"], dim=-1)
            top = probs.topk(top_k + 1, dim=-1).values
            gap = (top[:, top_k - 1] - top[:, top_k]) / top[:, top_k - 1]
            self.gaps.append(float(gap.min()))
            return orig(p, x, n_experts=n_experts, top_k=top_k,
                        capacity_factor=capacity_factor)
        self.layers.moe_block = observed
        return self

    def __exit__(self, *exc):
        self.layers.moe_block = self._orig

    def per_forward(self) -> list[float]:
        L = self.n_layers
        return [min(self.gaps[i:i + L]) for i in range(0, len(self.gaps), L)]


def run_serving(torch, device, model, params, prompts, *,
                max_new: int = SERVE_MAX_NEW, checked: int = SERVE_CHECKED,
                profile: bool = False) -> dict:
    """The serving path under each reload policy, held against the port's
    naive_generate and across policies (for the MoE family by phase 5's
    rule). Returns each kernel's launches over the policy runs."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.serve import Engine, naive_generate

    cfg = model.cfg
    L = cfg.n_layers
    vocab = cfg.vocab_size
    cuda = device.type == "cuda"
    moe = cfg.family == "moe"
    kernels = {"flash_attention": flash_attention, "rmsnorm": rmsnorm}
    if moe:
        kernels["moe_gmm"] = moe_gmm
    t = time.perf_counter()
    with Engine(model, params, serve_config("fixed")) as warm:  # warm-up:
        warm.generate([prompts[0][:64]], max_new=2)   # cuBLAS handles, pins
    del warm
    _phase("serving warm-up", t)

    t = time.perf_counter()
    oracle, oracle_margins, oracle_first, route_ties = [], [], [], []
    for i in range(checked):
        rows: list = []
        gaps = RouteGaps(torch, L) if moe else contextlib.nullcontext()
        with gaps:
            oracle.append(naive_generate(
                model, params, prompts[i], max_new=max_new, max_len=1024,
                rid=i,
                on_emit=lambda pos, row, rows=rows: rows.append(row.copy())))
        oracle_margins.append([_margin(r, vocab) for r in rows])
        oracle_first.append(rows[0])
        if moe:
            per_step = gaps.per_forward()
            assert len(per_step) == len(rows), (len(per_step), len(rows))
            route_ties.append([j for j, g in enumerate(per_step)
                               if g < ROUTE_RTOL])
            print(f"serve oracle request {i}: routing near ties at steps "
                  f"{route_ties[i]} ({len(route_ties[i])} of {len(rows)}; "
                  f"smallest gap {min(per_step):.3g}, tol {ROUTE_RTOL:g})",
                  flush=True)
        else:
            route_ties.append([])
    _phase("serving oracle (naive_generate)", t)

    launches = dict.fromkeys([*kernels, "flash_attention_tc",
                              "flash_attention_scalar", "moe_gmm_wgmma",
                              "moe_gmm_mma"], 0)
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
        gc.collect()               # the last run's engine and its cache
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():         # the serving path starts here
            reset_launches(fn)
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new=max_new)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {name: fn.launches for name, fn in kernels.items()}
        fa_tc = flash_attention.launches_tc
        fa_scalar = flash_attention.launches_scalar
        gmm_wgmma, gmm_mma = moe_gmm.launches_wgmma, moe_gmm.launches_mma
        peak = torch.cuda.max_memory_allocated() if cuda else None
        eng.close()
        st = eng.stats
        del eng
        forwards = st.prefill_calls + st.decode_steps
        want = {"flash_attention": L * st.prefill_calls,
                "rmsnorm": (2 * L + 1) * forwards, "moe_gmm": 3 * L * forwards}
        first_err = [float(np.abs(first[i] - oracle_first[i]).max()
                           / np.abs(oracle_first[i]).max())
                     for i in range(checked)]
        full = sum(agree_to_first_tie(oracle[i], out[i], oracle_margins[i],
                                      route_ties[i])
                   for i in range(checked))
        counts = " ".join(f"{name}_launches {n[name]} (= {want[name]})"
                          for name in kernels)
        counts += (f" flash_attention_launches_tc {fa_tc} "
                   f"flash_attention_launches_scalar {fa_scalar}")
        if moe:
            counts += (f" moe_gmm_launches_wgmma {gmm_wgmma} "
                       f"moe_gmm_launches_mma {gmm_mma}")
        print(f"serve {cfg.name} policy={policy}: wall_s {wall:.3f} "
              f"prefill_time_s {st.prefill_time:.3f} decode_time_s "
              f"{st.decode_time:.3f} stall_time_s {st.stall_time:.3f} "
              f"decode_tok_s {st.decode_tok_s:.2f} tokens {st.tokens} "
              f"prefill_calls {st.prefill_calls} decode_steps "
              f"{st.decode_steps} swaps {st.swaps} offload_bytes "
              f"{st.offload_bytes} reload_bytes {st.reload_bytes} "
              f"peak_allocated_bytes {peak} {counts} "
              f"first_token_logits_max_err/max|logit| "
              f"{[f'{e:.3g}' for e in first_err]} (tol {SERVE_RTOL:g}) "
              f"match_naive_in_full {full}/{checked}", flush=True)
        assert all(len(o) == max_new for o in out), "a request fell short"
        assert all(0 <= tok < vocab for o in out for tok in o)
        assert st.swaps > 0 and st.offload_bytes > 0 and st.reload_bytes > 0, \
            "no swap went over the copy streams"
        if cuda:                  # on the CPU the wrappers launch nothing
            for name in kernels:
                assert n[name] == want[name] > 0, \
                    f"{name} launched {n[name]} times, expected {want[name]}"
            assert_flash_on_tensor_cores(flash_attention)
            if moe:
                assert_gmm_on_wgmma(moe_gmm)
        for i in range(checked):
            if 0 not in route_ties[i]:
                assert first_err[i] <= SERVE_RTOL, \
                    f"first-token logits of request {i} disagree"
        for name in kernels:
            launches[name] += n[name]
        launches["flash_attention_tc"] += fa_tc
        launches["flash_attention_scalar"] += fa_scalar
        launches["moe_gmm_wgmma"] += gmm_wgmma
        launches["moe_gmm_mma"] += gmm_mma
        streams[policy] = out
        margins_of[policy] = margins
    ref_policy = SERVE_POLICIES[0]
    for policy in SERVE_POLICIES[1:]:
        if moe:       # the same batch shapes: no allowance
            full = sum(streams[ref_policy][i] == streams[policy][i]
                       for i in range(len(prompts)))
            assert full == len(prompts), \
                f"policy {policy} disagrees with {ref_policy}"
        else:
            full = sum(agree_to_first_tie(streams[ref_policy][i],
                                          streams[policy][i],
                                          margins_of[ref_policy][i])
                       for i in range(len(prompts)))
        print(f"serve {cfg.name} policy={policy} vs {ref_policy}: "
              f"match_in_full {full}/{len(prompts)}", flush=True)
    if profile:
        def served() -> float:
            gc.collect()
            with Engine(model, params, serve_config("critical-path")) as eng:
                t0 = time.perf_counter()
                eng.generate(prompts, max_new=max_new)
                torch.cuda.synchronize()
                return time.perf_counter() - t0
        profile_run(torch, f"serve {cfg.name} policy=critical-path", served)
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


def profile_run(torch, label: str, run) -> float | None:
    """One run under torch.profiler: the card's busy time and idle share
    over the run's wall time, and device time by kernel name. ``run``
    returns the wall time in seconds, or a runtime's RunResult, whose
    host-span busy time is then printed beside the profiler's. Returns
    the card's busy time in ms (None when the profiler saw no device
    event)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = run()
        torch.cuda.synchronize()
    rr = got if hasattr(got, "makespan") else None
    wall_s = rr.makespan if rr is not None else got
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
        return None
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
    if rr is not None:
        print(f"profile {label}: host_busy_ms {rr.busy[0] * 1e3:.2f} (the "
              f"compute vertices' host spans) against the card's "
              f"{busy_us / 1e3:.2f}", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        print(f"profile {label}: {ms:9.3f} ms {n:5d}x {name[:100]}",
              flush=True)
    return busy_us / 1e3


def placement(torch, base: int, rr) -> str:
    """ROADMAP C2: the HBM a run allocated beyond ``base`` (its peak) is
    within the arena, the outputs it returned on the card and
    HBM_ALLOWANCE. Returns the terms, printed by the caller."""
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    outs = sum(t.numel() * t.element_size() for t in rr.outputs.values()
               if t.is_cuda)
    rest = peak - rr.arena_bytes - outs
    assert peak <= rr.arena_bytes + outs + HBM_ALLOWANCE, \
        (f"run allocated {peak} B beyond its base: arena {rr.arena_bytes} "
         f"+ outputs {outs} + {rest} > allowance {HBM_ALLOWANCE}")
    return (f"peak_over_base {peak} = arena {rr.arena_bytes} + outputs "
            f"{outs} + rest {rest} (allowance {HBM_ALLOWANCE})")


def counters(rr) -> str:
    return (f"n_compiled {rr.n_compiled} n_interpreted {rr.n_interpreted} "
            f"fused_dma_batches {rr.fused_dma_batches} n_inline "
            f"{rr.n_inline} n_threaded {rr.n_threaded}")


def plan_runs(torch, device, tr, res, cap, inputs, *, label: str,
              n_rms: int, check, runs=POLICY_RUNS, n_rms_bwd: int = 0) -> dict:
    """The policy runs of one plan under both executor backends, each with
    its placement bound (C2) and rmsnorm (and rmsnorm_bwd) launches
    asserted and its outputs
    held by ``check(rr, interpreted_rr_of_the_same_policy)``, which
    returns a description. One compiled policy (TWICE_POLICY) runs twice:
    whether the two runs give the same bytes is printed. Returns the runs
    by (backend, policy, mode)."""
    from repro_torch.core.runtime import TurnipRuntime
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd

    def measured(rt):
        before, before_bwd = rmsnorm.launches, rmsnorm_bwd.launches
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        rr = rt.run(inputs)
        mem = placement(torch, base, rr) if device.type == "cuda" else ""
        n = rmsnorm.launches - before
        assert n == n_rms or device.type != "cuda", \
            f"rmsnorm launched {n} times, expected {n_rms}"
        n_bwd = rmsnorm_bwd.launches - before_bwd
        assert n_bwd == n_rms_bwd or device.type != "cuda", \
            f"rmsnorm_bwd launched {n_bwd} times, expected {n_rms_bwd}"
        return rr, n, mem

    out = {}
    for backend in EXEC_BACKENDS:
        for policy, mode in runs:
            rt = TurnipRuntime(tr.tg, res, backend="bytes",
                               capacities={0: cap}, policy=policy, mode=mode,
                               seed=0, device=device, exec_backend=backend)
            rr, n, mem = measured(rt)
            desc = check(rr, out.get(("interpreted", policy, mode)))
            print(f"{label} {backend} policy={policy} mode={mode}: "
                  f"makespan_ms {rr.makespan * 1e3:.2f} host_busy_ms "
                  f"{rr.busy[0] * 1e3:.2f} host_stall_ms "
                  f"{rr.stall[0] * 1e3:.2f} offload_bytes "
                  f"{rr.offload_bytes} reload_bytes {rr.reload_bytes} "
                  f"h2d_ms {rr.transfer_time['h2d'] * 1e3:.2f} d2h_ms "
                  f"{rr.transfer_time['d2h'] * 1e3:.2f} compute_launch_ms "
                  f"{rr.launch_time.get('compute', 0.0) * 1e3:.2f} "
                  f"rmsnorm_launches {n} {counters(rr)} {mem} {desc}",
                  flush=True)
            out[(backend, policy, mode)] = rr
            if backend == "compiled" and (policy, mode) == TWICE_POLICY:
                again, _, mem = measured(rt)
                same = all(torch.equal(rr.outputs[t], again.outputs[t])
                           for t in rr.outputs)
                print(f"{label} compiled policy={policy} mode={mode} again: "
                      f"makespan_ms {again.makespan * 1e3:.2f} "
                      f"byte_equal_to_first {same} {mem}", flush=True)
    return out


def run_main_path(torch, device, tr, res, cap, inputs, *, n_rms: int,
                  profile: dict | None = None) -> tuple[dict, dict]:
    """Warm-up plus the policy runs under both backends (plan_runs). With
    ``profile`` (a dict), one profiled run per backend and mode under
    policy ``fixed``, whose device busy times are added to it by
    (backend, mode). Returns the launches of each kernel over the
    measured runs, and the runs."""
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

    def runtime(policy, mode, backend="interpreted"):
        return TurnipRuntime(tr.tg, res, backend="bytes", capacities={0: cap},
                             policy=policy, mode=mode, seed=0, device=device,
                             exec_backend=backend)

    t = time.perf_counter()
    runtime("random", "nondet").run(inputs)          # warm-up: pinned pools,
    runtime("random", "nondet", "compiled").run(inputs)   # cuBLAS handles
    _phase("warm-up runs", t)

    def check(rr, interpreted) -> str:
        out = rr.outputs[L]
        assert out.device.type == device.type and \
            rr.arena_device.startswith(device.type), "run left the device"
        assert all(v.device.type == device.type
                   for v in rr.outputs.values())
        assert out.shape == ref.shape and torch.isfinite(out).all()
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= LOGIT_RTOL * scale, "logits disagree with plain eval"
        desc = (f"logits_max_err_vs_plain {err:.3g} (tol {LOGIT_RTOL:g}*"
                f"{scale:.3g})")
        if interpreted is not None:
            e2 = (out.float() - interpreted.outputs[L].float()).abs() \
                .max().item()
            assert e2 <= LOGIT_RTOL * scale, \
                "compiled logits disagree with the interpreted run"
            desc += f" max_err_vs_interpreted {e2:.3g}"
        return desc

    rmsnorm.launches = 0                  # the main path starts here
    runs = plan_runs(torch, device, tr, res, cap, inputs, label="prefill",
                     n_rms=n_rms, check=check)
    launches = {"rmsnorm": rmsnorm.launches}
    if profile is not None:
        for backend in EXEC_BACKENDS:
            for mode in ("nondet", "fixed"):
                profile[(backend, mode)] = profile_run(
                    torch, f"prefill {backend} policy=fixed mode={mode}",
                    lambda: runtime("fixed", mode, backend).run(inputs))
    return launches, runs


def lora_capacity(cfg, n_layers: int = LORA_LAYERS) -> int:
    """fig11's tightest budget, 2.5 GiB for the whole model, scaled to the
    depth: 251,658,240 B for 3 of llama-7b's 32 layers."""
    return int(LORA_BUDGET_GIB * 2**30 * n_layers / cfg.n_layers)


def build_lora_path(seq_len: int, *, arch=None, n_layers=LORA_LAYERS,
                    cap=None, dtype="float16"):
    """Trace and plan fig11's LoRA fwd+bwd at ``seq_len`` tokens with one
    device. Returns (traced, result, capacity)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import BuildConfig, build_memgraph
    from repro_torch.core.trace import TraceConfig, trace_lora_train

    cfg = arch if arch is not None else get_arch("llama-7b")
    tr = trace_lora_train(cfg, seq_len=seq_len, n_layers=n_layers,
                          trace=TraceConfig(n_devices=1, head_group=8,
                                            q_block=max(512, seq_len // 2),
                                            mlp_slices=2, dtype=dtype))
    cap = lora_capacity(cfg, n_layers) if cap is None else cap
    res = build_memgraph(tr.tg, BuildConfig(
        capacity=cap, size_fn=lambda v: -(-v.out.nbytes // 256) * 256))
    assert res.n_offloads > 0 and res.n_reloads > 0, \
        f"the LoRA plan under {cap} B does not offload"
    return tr, res, cap


def run_lora_path(torch, device, tr, res, cap, inputs, *,
                  profile: dict | None = None) -> dict:
    """The LoRA plan's policy runs under both backends, each adapter
    gradient held against the port's plain evaluation (LORA_GRAD_RTOL,
    each gradient alone), and ``rmsnorm_bwd``'s device time at its shapes
    (CUDA events, one vertex timed, times the vertices). With ``profile``
    (a dict), one profiled compiled run per mode under policy ``fixed``,
    whose device busy times are added to it by (backend, mode). Returns
    the runs."""
    from repro_torch.core.runtime import TurnipRuntime, eval_taskgraph

    t = time.perf_counter()
    T = tr.tg.vertices[tr.input_tid].out.shape[0]
    grads = tr.grad_tids
    assert grads, "the LoRA graph has no gradient outputs"
    plain = eval_taskgraph(tr.tg, inputs, device=device, plain=True)
    ref = {tid: plain[tid] for tid in grads.values()}
    del plain
    scales = {}
    for name, tid in grads.items():
        assert bool(torch.isfinite(ref[tid]).all()), \
            f"the plain float16 gradient {name} is not finite (overflow)"
        scales[tid] = ref[tid].float().abs().max().item()
        assert scales[tid] > 0, f"the plain gradient {name} is zero"
    if device.type == "cuda":
        torch.cuda.synchronize()
    _phase(f"LoRA T={T} plain evaluation", t)
    mg = res.memgraph
    bwd = [m for m, v in mg.vertices.items() if v.op_name == "rmsnorm_bwd"]
    n_rms = sum(v.op == "rmsnorm" for v in tr.tg.vertices.values())

    def check(rr, interpreted) -> str:
        worst = 0.0
        for name, tid in grads.items():
            out = rr.outputs[tid]
            assert bool(torch.isfinite(out).all()), f"grad {name} not finite"
            err = (out.float().to(ref[tid].device)
                   - ref[tid].float()).abs().max().item()
            worst = max(worst, err / scales[tid])
            assert err <= LORA_GRAD_RTOL * scales[tid], \
                (f"grad {name}: max|run - plain| {err:.3g} > "
                 f"{LORA_GRAD_RTOL:g} x {scales[tid]:.3g}")
        return (f"grads {len(grads)} max_err/max|plain| {worst:.3g} "
                f"(tol {LORA_GRAD_RTOL:g})")

    t = time.perf_counter()
    TurnipRuntime(tr.tg, res, backend="bytes", capacities={0: cap},
                  policy="random", seed=0, device=device).run(inputs)
    _phase("LoRA warm-up run", t)
    runs = plan_runs(torch, device, tr, res, cap, inputs,
                     label=f"lora T={T}", n_rms=n_rms, check=check,
                     n_rms_bwd=len(bwd))
    if device.type == "cuda" and bwd:
        v = tr.tg.vertices[mg.vertices[bwd[0]].src_tid]
        one_ms = vertex_ms(torch, device, tr.tg, v, 10)
        print(f"lora T={T}: rmsnorm_bwd device_ms {one_ms:.4f} a vertex "
              f"({[tuple(tr.tg.vertices[i].out.shape) for i in v.inputs]} "
              f"{v.out.dtype}, the backward kernel), {len(bwd)} vertices: "
              f"{one_ms * len(bwd):.3f} ms a run", flush=True)
    if profile is not None:
        for mode in ("nondet", "fixed"):
            profile[("compiled", mode)] = profile_run(
                torch, f"lora T={T} compiled policy=fixed mode={mode}",
                lambda: TurnipRuntime(
                    tr.tg, res, backend="bytes", capacities={0: cap},
                    policy="fixed", mode=mode, seed=0, device=device,
                    exec_backend="compiled").run(inputs))
    return runs


def _event_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def vertex_ms(torch, device, tg, v, reps: int) -> float:
    """Median CUDA-event time of task vertex ``v``'s op at its shapes, on
    operands drawn from a seeded generator, written into an output of its
    own (one untimed call first)."""
    from repro_torch.core.ops import get_op
    gen = torch.Generator(device=device).manual_seed(0)
    vals = [torch.randn(tg.vertices[i].out.shape, generator=gen,
                        device=device).to(tg.vertices[i].out.torch_dtype)
            for i in v.inputs]
    out = torch.empty(v.out.shape, dtype=v.out.torch_dtype, device=device)
    fn = get_op(v.op)
    fn(*vals, out=out, **v.params)
    return _event_ms(torch, lambda: fn(*vals, out=out, **v.params), reps)


def measure_hardware(torch, device, tg):
    """An H100 HardwareModel measured on this card: h2d and d2h rates of a
    pinned 256 MiB copy, the time of a 4 KiB pinned copy (dma_latency),
    the rate of a 1 GiB copy inside HBM counting the bytes read and
    written (hbm_bw, as the model charges 3 x nbytes per vertex), an
    empty kernel's device time (kernel_overhead), and the effective rate
    of the largest-FLOP compute vertex of ``tg`` at its shapes (flops).
    d2d_bw, disk and NIC keep the defaults: one card has no second device,
    and the smoke moves nothing over disk or a NIC."""
    from repro_torch.core.simulate import HardwareModel

    big = 256 * 2**20
    host = torch.empty(big, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(big, dtype=torch.uint8, device=device)
    h2d_ms = _event_ms(torch, lambda: dev.copy_(host, non_blocking=True), 10)
    d2h_ms = _event_ms(torch, lambda: host.copy_(dev, non_blocking=True), 10)
    small_h, small_d = host[:4096], dev[:4096]
    lat_ms = _event_ms(torch, lambda: small_d.copy_(small_h,
                                                    non_blocking=True), 100)
    src = torch.empty(2**30, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    hbm_ms = _event_ms(torch, lambda: dst.copy_(src), 10)
    del src, dst, dev, host
    empty_ms = _event_ms(torch, lambda: torch.cuda._sleep(0), 100)
    v = max((v for v in tg.vertices.values() if v.kind.value == "compute"),
            key=lambda v: v.flops)
    mm_ms = vertex_ms(torch, device, tg, v, 30)
    hw = HardwareModel(flops=v.flops / (mm_ms / 1e3),
                       hbm_bw=2 * 2**30 / (hbm_ms / 1e3),
                       h2d_bw=big / (h2d_ms / 1e3),
                       d2h_bw=big / (d2h_ms / 1e3),
                       kernel_overhead=empty_ms / 1e3,
                       dma_latency=lat_ms / 1e3)
    print(f"hardware: h2d 256 MiB {h2d_ms:.4f} ms, d2h {d2h_ms:.4f} ms, "
          f"4 KiB h2d {lat_ms:.5f} ms, 1 GiB HBM copy {hbm_ms:.4f} ms, "
          f"empty launch {empty_ms:.5f} ms, {v.op} {v.name} "
          f"{[tuple(tg.vertices[i].out.shape) for i in v.inputs]} "
          f"{v.out.dtype} {v.flops:.4g} flop {mm_ms:.4f} ms", flush=True)
    print(f"hardware model: {hw!r}", flush=True)
    return hw


def sim_vs_measured(label: str, res, hw, runs: dict,
                    profiled: dict) -> None:
    """The simulator's makespan of ``res`` under ``hw`` beside the measured
    runs of the same dispatch (policy ``fixed``; ``nondet`` and ``fixed``
    mode) under both backends, and beside the card's busy time where the
    profiler measured a run of it (``profiled``, by (backend, mode);
    ``--profile``). Reported, not asserted."""
    from repro_torch.core.simulate import simulate
    for mode in ("nondet", "fixed"):
        sim = simulate(res.memgraph, hw, mode=mode, policy="fixed")
        line = (f"A7 {label} mode={mode}: sim_makespan_ms "
                f"{sim.makespan * 1e3:.3f} sim_busy_ms "
                f"{sim.busy[0] * 1e3:.3f}")
        for backend in EXEC_BACKENDS:
            rr = runs[(backend, "fixed", mode)]
            line += (f" | {backend}: makespan_ms {rr.makespan * 1e3:.2f} "
                     f"sim/makespan {sim.makespan / rr.makespan:.4f}")
            busy = profiled.get((backend, mode))
            if busy:
                line += (f" profiled_device_busy_ms {busy:.2f} "
                         f"sim/device_busy {sim.makespan * 1e3 / busy:.4f}")
        print(line, flush=True)


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


def build_recurrent(torch, device, arch):
    """``arch`` (rwkv6-7b or zamba2-7b) at full width and depth, bfloat16,
    random weights drawn on the card from ``torch.Generator(seed 0)``. For
    rwkv6-7b the leaves the reference initialises to zero (the static
    mixes, the mix and decay LoRAs' B factors, the channel-mix
    coefficients; ``bonus_u``) are redrawn from a second seeded generator
    as 0.1 x N(0, 1) (``bonus_u`` 0.5 x N(0, 1)): left at zero, the token
    shifts, the data-dependent decay and the bonus term would never be
    exercised."""
    model, params = build_serving(torch, device, arch=arch)
    if model.cfg.family == "rwkv":
        gen = torch.Generator(device=device).manual_seed(1)
        lp = params["layers"]
        for name in ("mix_rkvwg", "mix_lora_B", "w_lora_B", "bonus_u",
                     "cmix_k", "cmix_r"):
            scale = 0.5 if name == "bonus_u" else 0.1
            lp[name].copy_(torch.randn(lp[name].shape, generator=gen,
                                       device=device) * scale)
    return model, params


def recurrent_launches_per_forward(cfg) -> dict[str, int]:
    """Kernel launches of one ``apply``: per rwkv layer one wkv6 and one
    rmsnorm (``ln_x``; its other norms are layernorms); per zamba Mamba
    layer one ssd_scan and one rmsnorm, per shared-block call one flash
    attention and two rmsnorm, and the final norm."""
    if cfg.family == "rwkv":
        return {"wkv6": cfg.n_layers, "rmsnorm": cfg.n_layers}
    calls = cfg.n_layers // cfg.zamba_group
    return {"ssd_scan": cfg.n_layers, "flash_attention": calls,
            "rmsnorm": cfg.n_layers + 2 * calls + 1}


def run_recurrent(torch, device, model, params, *,
                  profile: bool = False) -> dict:
    """The recurrent path's throughput: ``apply`` on RECURRENT_TOKENS (one
    warm-up, then RECURRENT_TIMED timed runs, each kernel's launches
    asserted per forward). Then the model's bfloat16 noise floor, printed:
    the logits of the first DECODE_CHECK[1] tokens' first position from
    ``apply`` on all of them against ``apply`` on that one token, the same
    code at another batch shape (cuBLAS picks other kernels, which round
    the last bit otherwise). Returns the launches of the timed runs."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    cfg = model.cfg
    cuda = device.type == "cuda"
    per_fwd = recurrent_launches_per_forward(cfg)
    kernels = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
               "ssd_scan": ssd_scan, "wkv6": wkv6}
    kernels = {name: kernels[name] for name in per_fwd}
    B, S = RECURRENT_TOKENS
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(
        device)

    def forward():
        out = model.apply(params, toks)
        if cuda:
            torch.cuda.synchronize()
        return out

    t = time.perf_counter()
    for fn in kernels.values():
        reset_launches(fn)
    logits = forward()                      # warm-up: cuBLAS handles
    n = {name: fn.launches for name, fn in kernels.items()}
    assert tuple(logits.shape) == (B, S, cfg.padded_vocab), logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    del logits
    _phase(f"{cfg.name} warm-up apply", t)
    if cuda:
        for name in kernels:
            assert n[name] == per_fwd[name], \
                f"{name} launched {n[name]} times, expected {per_fwd[name]}"
        if "flash_attention" in kernels:
            assert_flash_on_tensor_cores(flash_attention)
        torch.cuda.reset_peak_memory_stats()
    walls = []
    for fn in kernels.values():             # the recurrent path starts here
        reset_launches(fn)
    for _ in range(RECURRENT_TIMED):
        t0 = time.perf_counter()
        forward()
        walls.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in kernels.items()}
    scans = [name for name in ("ssd_scan", "wkv6") if name in kernels]
    for name in scans:
        launches[f"{name}_kernel"] = kernels[name].kernel_launches
    peak = torch.cuda.max_memory_allocated() if cuda else None
    med = statistics.median(walls)
    counts = " ".join(f"{name}_launches {launches[name]} "
                      f"(= {RECURRENT_TIMED} x {per_fwd[name]})"
                      for name in kernels)
    for name in scans:
        counts += (f" {name}_kernel_launches "
                   f"{launches[f'{name}_kernel']}")
    print(f"recurrent {cfg.name} apply {B}x{S}: median_ms {med * 1e3:.2f} "
          f"walls_ms {[round(w * 1e3, 2) for w in walls]} tokens_per_s "
          f"{B * S / med:.1f} peak_allocated_bytes {peak} {counts}",
          flush=True)
    if cuda:
        for name in kernels:
            want = RECURRENT_TIMED * per_fwd[name]
            assert launches[name] == want, \
                f"{name} launched {launches[name]} times, expected {want}"
        for name in scans:                 # three device launches a call
            assert launches[f"{name}_kernel"] == 3 * launches[name], \
                (name, launches[f"{name}_kernel"], launches[name])
        if "flash_attention" in kernels:
            assert_flash_on_tensor_cores(flash_attention)
            print(f"recurrent {cfg.name}: flash_attention_launches_tc "
                  f"{flash_attention.launches_tc} launches_scalar "
                  f"{flash_attention.launches_scalar}", flush=True)

    Bd, Sd = DECODE_CHECK
    dtoks = decode_tokens(torch, device, cfg.vocab_size)
    V = cfg.vocab_size
    many = model.apply(params, dtoks)[:, 0, :V].float()
    one = model.apply(params, dtoks[:, :1])[:, 0, :V].float()
    floor = float(((many - one).abs().amax(-1)
                   / many.abs().amax(-1)).max())
    print(f"recurrent {cfg.name} {cfg.dtype} noise floor: position-0 "
          f"logits of apply on {Bd}x{Sd} vs on {Bd}x1, max_err/max|logit| "
          f"{floor:.4g}", flush=True)
    if profile:
        def once() -> float:
            t0 = time.perf_counter()
            forward()
            return time.perf_counter() - t0
        profile_run(torch, f"recurrent {cfg.name} apply {B}x{S}", once)
    return launches


def decode_tokens(torch, device, vocab: int):
    """DECODE_CHECK tokens, numpy seed 1."""
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.integers(0, vocab, DECODE_CHECK)).to(device)


def decode_check(torch, device, arch) -> None:
    """Decode against apply, the reference's own check (``tests/
    test_models_smoke.py::test_decode_matches_prefill``), at full width
    and depth, on ``arch`` drawn in float32 (``build_recurrent``'s seeds).
    The rule was fixed before the path first ran on the card: ``apply``'s
    logits on DECODE_CHECK tokens against those of one ``decode_step`` a
    token from ``init_cache`` (the one-token recurrences, no scan kernel),
    at every position; each position's logits agree within LOGIT_RTOL x
    that position's max |logit| of ``apply``; the argmax over the
    vocabulary is equal unless ``apply``'s top two logits there lie within
    that distance (a near tie).

    Why float32. The rule was first run on the bfloat16 model and failed
    at position 0, where decode and apply see the same inputs: these
    random-weight models grow a last-bit difference tens of times over
    their depth, and ``run_recurrent``'s noise-floor line shows two
    bfloat16 ``apply`` calls on the same token, at two batch shapes,
    disagreeing by more than the rule allows. In float32 (TF32 off) the
    rounding is 2^16 times finer, so the rule holds the scan kernels in
    ``apply`` against the recurrences in decode and not against the
    rounding."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(arch, dtype="float32")
    t = time.perf_counter()
    model, params = build_recurrent(torch, device, cfg32)
    cfg = model.cfg
    Bd, Sd = DECODE_CHECK
    dtoks = decode_tokens(torch, device, cfg.vocab_size)
    V = cfg.vocab_size
    full = model.apply(params, dtoks)[..., :V].float()
    cache = model.init_cache(Bd, DECODE_MAX_LEN)
    worst, ties, mismatched = 0.0, 0, []
    for i in range(Sd):
        step, cache = model.decode_step(params, cache, dtoks[:, i:i + 1], i)
        got = step[:, :V].float()
        want = full[:, i]
        scale = want.abs().amax(dim=-1)                    # [Bd]
        err = (got - want).abs().amax(dim=-1)
        worst = max(worst, float((err / scale).max()))
        assert bool((err <= LOGIT_RTOL * scale).all()), \
            f"decode logits at position {i} differ by {err.tolist()} " \
            f"(tol {LOGIT_RTOL:g} x {scale.tolist()})"
        top2 = want.topk(2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) < LOGIT_RTOL * scale
        ties += int(tie.sum())
        if bool(((got.argmax(-1) != want.argmax(-1)) & ~tie).any()):
            mismatched.append(i)
    wall = time.perf_counter() - t
    print(f"recurrent {cfg.name} float32 decode vs apply {Bd}x{Sd}: "
          f"max_err/max|logit| {worst:.4g} (tol {LOGIT_RTOL:g}) near_ties "
          f"{ties} of {Bd * Sd} argmax_mismatch_outside_ties {mismatched} "
          f"({wall:.2f} s with the float32 draw)", flush=True)
    assert not mismatched, f"argmax differs at positions {mismatched}"
    del model, params, full, cache

AB_ROUNDS = 5
# (name, which checkout, cuBLAS's default workspace): this tree as the
# smoke runs it, the other tree as its own smoke ran (no workspace set),
# and this tree with the default workspace, which tells the two apart
AB_VARIANTS = (("other", True, True), ("tree", False, False),
               ("tree-default-ws", False, True))


def ab_prefill(other_root: str, rounds: int = AB_ROUNDS) -> int:
    """The interpreted prefill of this checkout's port against another
    checkout's (``other_root``), in separate processes taken in turns:
    AB_VARIANTS in order, then in reverse, ``rounds`` times. The inputs
    are drawn once here (``make_inputs(seed=0)``) and saved under
    ``build/ab_inputs``. Each worker (``ab_worker``) plans the prefill with
    its own port, loads those inputs, runs one warm-up and the POLICY_RUNS
    once each under the interpreted backend, checks the logits are finite
    and prints the makespans. The medians by variant and policy come
    last."""
    other_src = os.path.join(os.path.abspath(other_root), "src")
    if not os.path.isdir(os.path.join(other_src, "repro_torch")):
        raise SystemExit(f"no port under {other_src}")
    tr, _, _ = build_main_path()
    inputs_dir = os.path.join(ROOT, "build", "ab_inputs")
    os.makedirs(inputs_dir, exist_ok=True)
    for tid, a in tr.make_inputs(seed=0).items():
        np.save(os.path.join(inputs_dir, f"{tid}.npy"), a)
    del tr
    seen: dict[str, dict[str, list[float]]] = {}
    for r in range(rounds):
        order = AB_VARIANTS if r % 2 == 0 else AB_VARIANTS[::-1]
        for name, other, default_ws in order:
            cmd = [sys.executable, os.path.abspath(__file__), "--ab-worker",
                   other_src if other else os.path.join(ROOT, "src"),
                   inputs_dir] + (["--default-workspace"] if default_ws
                                  else [])
            env = {k: v for k, v in os.environ.items()
                   if k not in ("CUBLAS_WORKSPACE_CONFIG", "PYTHONPATH")}
            got = subprocess.run(cmd, capture_output=True, text=True,
                                 env=env, cwd=ROOT, timeout=600)
            lines = [ln for ln in got.stdout.splitlines()
                     if ln.startswith("AB ")]
            if got.returncode != 0 or not lines:
                print(got.stdout[-3000:], got.stderr[-3000:], flush=True)
                raise RuntimeError(f"ab worker {name} failed "
                                   f"(rc {got.returncode})")
            got = json.loads(lines[-1][3:])
            ms = got["makespan_ms"]
            print(f"ab round {r} {name} ({got['port']}): " + " ".join(
                f"{k} {v:.2f}" for k, v in ms.items()), flush=True)
            for k, v in ms.items():
                seen.setdefault(name, {}).setdefault(k, []).append(v)
    for name, by_run in seen.items():
        print(f"ab median {name}: " + " ".join(
            f"{k} {statistics.median(v):.2f}" for k, v in by_run.items()),
            flush=True)
    return 0


def ab_worker(inputs_dir: str) -> int:
    """One ab_prefill process: the port on ``sys.path`` (SRC) plans and
    runs the interpreted prefill on the saved inputs."""
    import repro_torch.core
    import torch
    from repro_torch.core.bridge import inputs_from_reference
    from repro_torch.core.runtime import TurnipRuntime

    device = torch.device("cuda", 0)
    tr, res, cap = build_main_path()
    arrays = {int(f[:-4]): np.load(os.path.join(inputs_dir, f))
              for f in os.listdir(inputs_dir) if f.endswith(".npy")}
    inputs = inputs_from_reference(arrays, device=device)
    L = tr.meta["logits"]

    def run(policy, mode):
        return TurnipRuntime(tr.tg, res, backend="bytes", capacities={0: cap},
                             policy=policy, mode=mode, seed=0,
                             device=device).run(inputs)

    run("random", "nondet")                    # warm-up: pools, handles
    ms = {}
    for policy, mode in POLICY_RUNS:
        rr = run(policy, mode)
        assert bool(torch.isfinite(rr.outputs[L]).all()), "logits not finite"
        ms[f"{policy}/{mode}"] = rr.makespan * 1e3
    port = os.path.dirname(os.path.dirname(repro_torch.core.__file__))
    print("AB " + json.dumps({"port": port, "makespan_ms": ms}), flush=True)
    return 0


AB_TRAIN_STEPS = 4                 # timed steps a worker, after a warm-up


def ab_train(other_root: str, rounds: int = 2) -> int:
    """The LoRA training step of phase 10c (TRAIN_ARCH, SUPERVISED's batch
    and sequence, remat='offload') of this checkout's port against another
    checkout's (``other_root``), in separate processes taken in turns:
    other, tree, then tree, other, ``rounds`` times. Each worker
    (``ab_train_worker``) prints its step times and its profiled step's
    device time by kernel; the medians by checkout come last."""
    other_src = os.path.join(os.path.abspath(other_root), "src")
    if not os.path.isdir(os.path.join(other_src, "repro_torch")):
        raise SystemExit(f"no port under {other_src}")
    steps: dict[str, list[float]] = {}
    flash: dict[str, list[float]] = {}
    for r in range(rounds):
        order = (("other", other_src), ("tree", os.path.join(ROOT, "src")))
        for name, src in (order if r % 2 == 0 else order[::-1]):
            cmd = [sys.executable, os.path.abspath(__file__),
                   "--ab-train-worker", src]
            env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
            got = subprocess.run(cmd, capture_output=True, text=True,
                                 env=env, cwd=ROOT, timeout=900)
            out = got.stdout.splitlines()
            for ln in out:
                if ln.startswith("profile "):
                    print(f"ab round {r} {name}: {ln}", flush=True)
            lines = [ln for ln in out if ln.startswith("ABT ")]
            if got.returncode != 0 or not lines:
                print(got.stdout[-3000:], got.stderr[-3000:], flush=True)
                raise RuntimeError(f"ab train worker {name} failed "
                                   f"(rc {got.returncode})")
            res = json.loads(lines[-1][4:])
            print(f"ab round {r} {name} ({res['port']}): step_s "
                  f"{res['step_s']} warm-up {res['warmup_s']:.3f} s; "
                  f"profiled step device_ms {res['device_ms']:.3f}, flash "
                  f"backward {res['flash_bwd_ms']:.3f} ms", flush=True)
            steps.setdefault(name, []).extend(res["step_s"])
            flash.setdefault(name, []).append(res["flash_bwd_ms"])
    for name in steps:
        print(f"ab median {name}: step_s {statistics.median(steps[name]):.4f} "
              f"flash backward ms a step {statistics.median(flash[name]):.3f}",
              flush=True)
    return 0


def ab_train_worker() -> int:
    """One ab_train process: the port on ``sys.path`` (SRC) sets up the
    training run through repro_torch.launch.train, runs one warm-up step
    and AB_TRAIN_STEPS timed steps (host clock, ending in a synchronize),
    then one under torch.profiler."""
    import repro_torch.core
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train as T

    S = SUPERVISED
    r = T.setup(T.parse_args([
        "--arch", TRAIN_ARCH, "--lora", "--remat", "offload", "--batch",
        str(S["batch"]), "--seq", str(S["seq"]), "--device", "cuda"]))
    state, step_s = r.state, []
    for i in range(1 + AB_TRAIN_STEPS):
        batch = r.batch_fn(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = r.step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        assert math.isfinite(float(met["loss"])), "loss not finite"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, met = r.step_fn(state, r.batch_fn(1 + AB_TRAIN_STEPS))
        torch.cuda.synchronize()
    port = os.path.dirname(os.path.dirname(repro_torch.core.__file__))
    got = profile_kernels(prof, "train step remat=offload")
    print("ABT " + json.dumps({"port": port, "step_s": step_s[1:],
                               "warmup_s": step_s[0], **got}), flush=True)
    return 0


# --------------------------------------------------------------------------
# training (slice 9, ROADMAP A11b)
# --------------------------------------------------------------------------
def train_ops_bwd(B, Sq, Skv, Hq, Dh, causal, q_offset) -> int:
    """The attention backward's operations: five products (recomputed
    scores, dP, dV, dK, dQ) where the forward has two, 2.5 x flash_ops."""
    return 5 * flash_ops(B, Sq, Skv, Hq, Dh, causal, q_offset) // 2


def flash_bwd_bound_ms(B, Sq, Skv, Hq, Hkv, Dh, causal, q_offset,
                       itemsize) -> tuple[float, str]:
    """Least time for the attention backward: q, o, dO, k, v and the f32
    log-sum-exp read once, dQ, dK, dV written once; train_ops_bwd at the
    peak rate of the type."""
    ops = train_ops_bwd(B, Sq, Skv, Hq, Dh, causal, q_offset)
    t_ops = ops / (F32_FLOPS if itemsize == 4 else F16_FLOPS)
    q_elems, kv_elems = B * Sq * Hq * Dh, B * Skv * Hkv * Dh
    t_bytes = ((4 * q_elems + 4 * kv_elems) * itemsize + 4 * B * Hq * Sq) \
        / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rmsnorm_bwd_bound_ms(n_rows: int, d: int, itemsize: int,
                         dg: bool) -> tuple[float, str]:
    """Least time for rmsnorm's VJP: x, dy and g read once, dx (and dg)
    written once; 8 f32 operations per element (two sums, the dx formula;
    three more for dg)."""
    t_bytes = (3 * n_rows * d + (2 if dg else 1) * d) * itemsize \
        / HBM_BYTES_PER_S
    t_ops = (11 if dg else 8) * n_rows * d / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rmsnorm_bwd_phase(torch, device) -> dict:
    """rmsnorm_bwd against rmsnorm_bwd_plain at the training shape
    (RMS_BWD_MAIN, bfloat16, with and without dγ; timed) and on
    tests/test_kernels.py's rmsnorm sweep in three dtypes. dx within
    KERNEL_TOL; dγ, a sum over rows in another order, within KERNEL_TOL
    plus 2e-6 of the sum of its terms' magnitudes. Returns the record of
    the training path's call (no dγ: LoRA freezes the gains), with the
    dγ variant's times beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_bwd, rmsnorm_bwd_plain

    gen = torch.Generator(device=device).manual_seed(0)
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=device)
    cases = [(RMS_BWD_MAIN, torch.bfloat16, True)]
    for shape in [(7, 128), (3, 33, 256), (1, 512)]:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            cases.append((shape, dt, False))
    rec = {}
    for shape, dt, timed in cases:
        x, dy = (torch.randn(shape, generator=gen, device=device).to(dt)
                 for _ in range(2))
        g = torch.randn(shape[-1:], generator=gen, device=device).to(dt)
        name = str(dt).removeprefix("torch.")
        atol, rtol = KERNEL_TOL[name]
        for need_dg in (False, True):
            dx, dg = rmsnorm_bwd(x, g, dy, need_dg=need_dg)
            torch.cuda.synchronize()
            pdx, pdg = rmsnorm_bwd_plain(x, g, dy, need_dg=need_dg)
            err = (dx.float() - pdx.float()).abs()
            max_err = err.max().item()
            ok = bool((err <= atol + rtol * pdx.float().abs()).all())
            line = (f"kernel rmsnorm_bwd {'x'.join(map(str, shape))} {name} "
                    f"dg={need_dg}: dx max_abs_err {max_err:.3g} (tol "
                    f"{atol:g} + {rtol:g}*|plain|)")
            if need_dg:
                xf = x.float()
                terms = (dy.float() * xf * torch.rsqrt(
                    xf.square().mean(-1, keepdim=True) + 1e-6)
                         ).reshape(-1, shape[-1])
                lim = atol + rtol * pdg.float().abs() + \
                    2e-6 * terms.abs().sum(0)
                gerr = (dg.float() - pdg.float()).abs()
                ok = ok and bool((gerr <= lim).all())
                line += f" dg max err/limit {(gerr / lim).max().item():.3g}"
                del terms, xf
            line += f" ok={ok}"
            if timed:
                k_ms = _median_ms(lambda: rmsnorm_bwd(
                    x, g, dy, need_dg=need_dg, out=dx), torch, flush)
                p_ms = _median_ms(lambda: rmsnorm_bwd_plain(
                    x, g, dy, need_dg=need_dg), torch, flush, reps=10)
                xr = x.detach().requires_grad_()
                gr = g.detach().requires_grad_(need_dg)
                lib_ms = _median_ms(lambda: torch.autograd.grad(
                    F.rms_norm(xr, (shape[-1],), weight=gr, eps=1e-6),
                    [xr, gr] if need_dg else [xr], dy), torch, flush)
                bound_ms, bound_by = rmsnorm_bwd_bound_ms(
                    x.numel() // shape[-1], shape[-1], x.element_size(),
                    need_dg)
                line += (f" kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
                         f"library_ms {lib_ms:.4f} (F.rms_norm forward + "
                         f"backward) bound_ms {bound_ms:.4f} ({bound_by})")
                key = "" if not need_dg else "dg_"
                rec.update({f"{key}max_abs_err": max_err, f"{key}ms": k_ms,
                            f"{key}plain_ms": p_ms,
                            f"{key}bound_ms": bound_ms,
                            f"{key}bound_by": bound_by,
                            f"{key}library_ms": lib_ms})
            print(line, flush=True)
            if not ok:
                raise AssertionError(f"rmsnorm_bwd disagrees with its plain "
                                     f"version at {shape} {name} "
                                     f"dg={need_dg}")
            del dx, dg, pdx, pdg, err
    del flush
    return rec


def flash_bwd_phase(torch, device) -> dict:
    """flash_attention_bwd against flash_attention_bwd_plain (which
    computes its own log-sum-exp, one KV head at a time) at the training
    shapes (FLASH_BWD_MAIN, bfloat16, timed beside the backward of
    F.scaled_dot_product_attention through autograd, and the forward kernel
    timed without and with its log-sum-exp output) and on FLASH_BWD_SWEEP
    in three dtypes: dQ, dK, dV within gradient_limit, the forward's lse
    within 1e-5 of the plain one. Returns the record of the supervised
    run's shape (the first)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        gradient_limit, lse_plain)

    gen = torch.Generator(device=device).manual_seed(0)
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=device)
    cases = [(lbl, shp, torch.bfloat16, True) for lbl, shp in FLASH_BWD_MAIN]
    for lbl, shp in FLASH_BWD_SWEEP:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            cases.append((lbl, shp, dt, False))
    main = None
    for lbl, (B, Sq, Skv, Hq, Hkv, Dh, causal, off), dt, timed in cases:
        q, do = (torch.randn(B, Sq, Hq, Dh, generator=gen, device=device)
                 .to(dt) for _ in range(2))
        k, v = (torch.randn(B, Skv, Hkv, Dh, generator=gen, device=device)
                .to(dt) for _ in range(2))
        lse = torch.empty(B, Hq, Sq, device=device)
        o = flash_attention(q, k, v, causal=causal, q_offset=off, lse=lse)
        lse_err = (lse - lse_plain(q, k, causal, off)).abs().max().item() \
            if not timed else float("nan")
        got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                  q_offset=off)
        torch.cuda.synchronize()
        want = flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         q_offset=off)
        name = str(dt).removeprefix("torch.")
        max_err, ratio = 0.0, 0.0
        for a, b in zip(got, want):
            e = (a.float() - b.float()).abs()
            max_err = max(max_err, e.max().item())
            ratio = max(ratio, (e / gradient_limit(b, name)).max().item())
            del e
        ok = ratio <= 1.0 and not lse_err > 1e-5
        shape = (f"{B}x{Sq}x{Skv} h{Hq}/{Hkv} d{Dh} causal={causal} "
                 f"q_offset={off}")
        line = (f"kernel flash_attention_bwd {lbl} {shape} {name}: "
                f"max_abs_err {max_err:.3g} max err/limit {ratio:.3g} "
                f"(gradient_limit) lse_err {lse_err:.3g} ok={ok}")
        del want
        if timed:
            fwd_ms = _median_ms(lambda: flash_attention(
                q, k, v, causal=causal, q_offset=off, out=o), torch, flush,
                reps=10)
            fwd_lse_ms = _median_ms(lambda: flash_attention(
                q, k, v, causal=causal, q_offset=off, out=o, lse=lse), torch,
                flush, reps=10)
            k_ms = _median_ms(lambda: flash_attention_bwd(
                q, k, v, o, do, lse, causal=causal, q_offset=off), torch,
                flush, reps=10)
            p_ms = _median_ms(lambda: flash_attention_bwd_plain(
                q, k, v, o, do, causal=causal, q_offset=off), torch, flush,
                reps=3)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                enable_gqa=Hq != Hkv)
            dot = do.transpose(1, 2)
            lib_ms = _median_ms(lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dot, retain_graph=True), torch, flush,
                reps=10)
            del ot, qt, kt, vt
            bound_ms, bound_by = flash_bwd_bound_ms(
                B, Sq, Skv, Hq, Hkv, Dh, causal, off, q.element_size())
            line += (f" kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms "
                     f"{lib_ms:.4f} (SDPA backward) bound_ms {bound_ms:.4f} "
                     f"({bound_by}) forward_ms {fwd_ms:.4f} with lse "
                     f"{fwd_lse_ms:.4f} "
                     + rate(train_ops_bwd(B, Sq, Skv, Hq, Dh, causal, off),
                            k_ms, bound_ms))
            if main is None:
                main = dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=lib_ms)
        print(line, flush=True)
        if not ok:
            raise AssertionError(f"flash_attention_bwd disagrees with its "
                                 f"plain version at {lbl} {name}")
        del q, k, v, o, do, lse, got
    del flush
    return main


def _train_launches() -> dict:
    """The launch counts of the four kernels a dense training step runs,
    and the device launches of the two backward wrappers (``_kernel``)."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd)
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd
    return {"rmsnorm": rmsnorm.launches, "rmsnorm_bwd": rmsnorm_bwd.launches,
            "rmsnorm_bwd_kernel": rmsnorm_bwd.kernel_launches,
            "flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention_bwd.launches,
            "flash_attention_bwd_kernel": flash_attention_bwd.kernel_launches}


def assert_flash_bwd_on_tensor_cores() -> None:
    """Every flash backward call since the last reset went to the 16-bit
    wgmma instance."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    fb = flash_attention_bwd
    assert fb.launches_tc == fb.launches and fb.launches_scalar == 0, \
        (f"flash_attention_bwd: {fb.launches} calls, {fb.launches_tc} on "
         f"the tensor cores, {fb.launches_scalar} scalar")


# device operations of the flash backward, by kernel name
FLASH_BWD_KERNELS = ("attn_bwd_",)


def profile_kernels(prof, label: str, top: int = 15) -> dict:
    """The device operations of a torch.profiler trace by total device
    time, the ``top`` largest printed with their share of the summed device
    time, and the flash backward's kernels (FLASH_BWD_KERNELS) summed.
    Returns {"device_ms", "flash_bwd_ms", "top": [(name, ms, count)]}."""
    by_name: dict[str, tuple[float, int]] = {}
    for e in prof.events():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + (e.time_range.end - e.time_range.start)
                           / 1e3, n + 1)
    total = sum(ms for ms, _ in by_name.values())
    fb = sum(ms for name, (ms, _) in by_name.items()
             if any(k in name for k in FLASH_BWD_KERNELS))
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    for name, (ms, n) in rows:
        print(f"profile {label}: {ms:9.3f} ms {n:5d}x share "
              f"{ms / max(total, 1e-9):.3f} {name[:90]}", flush=True)
    print(f"profile {label}: device_ms {total:.3f} (sum over operations); "
          f"flash backward {fb:.3f} ms, share {fb / max(total, 1e-9):.3f}",
          flush=True)
    return {"device_ms": total, "flash_bwd_ms": fb,
            "top": [(name, ms, n) for name, (ms, n) in rows]}


def _reset_train_launches() -> None:
    """Zero the training kernels' launch counts and the offload's byte
    counts."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd)
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd
    from repro_torch.models.offload import reset_moved
    for fn in (flash_attention, flash_attention_bwd, rmsnorm, rmsnorm_bwd):
        reset_launches(fn)
    reset_moved()


def expected_train_launches(n_layers: int, remat, *, frozen_base: bool
                            ) -> dict:
    """Launches of one dense forward + backward: the forward's 2L + 1
    rmsnorm and L flash launches, once more for each layer (2L, L) when the
    backward recomputes it (every remat mode); one rmsnorm_bwd per norm on
    a gradient path (all but the first layer's input norm when the
    embedding is frozen, as under LoRA), one device launch each, two when
    its gain takes a gradient (not under LoRA: the base is frozen); one
    flash_attention_bwd a layer, two device launches each (Di and dQ,
    then dK and dV)."""
    L = n_layers
    again = 0 if remat is None else 1
    n_bwd = 2 * L + 1 - (1 if frozen_base else 0)
    return {"rmsnorm": 2 * L + 1 + again * 2 * L,
            "rmsnorm_bwd": n_bwd,
            "rmsnorm_bwd_kernel": n_bwd * (1 if frozen_base else 2),
            "flash_attention": L + again * L,
            "flash_attention_bwd": L,
            "flash_attention_bwd_kernel": 2 * L}


def _check_offload(cfg, batch: int, seq: int, steps: int = 1) -> dict:
    """remat='offload' moved every layer's input out and back once a step
    since the last ``_reset_train_launches``; returns the byte counts."""
    from repro_torch.models.offload import moved
    itemsize = {"bfloat16": 2, "float16": 2, "float32": 4}[cfg.dtype]
    want = steps * cfg.n_layers * batch * seq * cfg.d_model * itemsize
    got = dict(moved)
    assert got == {"offloaded": want, "reloaded": want}, \
        f"offload moved {got}, expected {want} B each way"
    return got


def _check_launches(label: str, got: dict, want: dict, steps: int = 1) -> None:
    want = {k: v * steps for k, v in want.items()}
    assert got == want, f"{label}: launches {got}, expected {want}"


@contextlib.contextmanager
def plain_layers():
    """layers.rmsnorm and layers.blockwise_attention swapped for their
    plain versions, forward and backward (the oracle of the training
    checks): ``rmsnorm_plain`` with ``rmsnorm_bwd_plain``, and
    ``flash_attention_plain`` with ``flash_attention_bwd_plain`` (which
    recomputes the scores and takes Di from the forward's output), the
    formulas the kernels compute, in plain torch; no kernel runs."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_plain, flash_attention_plain)
    from repro_torch.kernels.rmsnorm.ops import (rmsnorm_bwd_plain,
                                                 rmsnorm_plain)
    from repro_torch.models import layers

    class PlainRMS(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, g, eps):
            ctx.save_for_backward(x, g)
            ctx.eps = eps
            return rmsnorm_plain(x, g, eps=eps)

        @staticmethod
        def backward(ctx, dy):
            x, g = ctx.saved_tensors
            dx, dg = rmsnorm_bwd_plain(x, g, dy, eps=ctx.eps,
                                       need_dg=ctx.needs_input_grad[1])
            return dx, dg, None

    class PlainAttn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, q_offset):
            o = flash_attention_plain(q, k, v, causal=causal,
                                      q_offset=q_offset)
            ctx.save_for_backward(q, k, v, o)
            ctx.causal, ctx.q_offset = causal, q_offset
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o = ctx.saved_tensors
            return (*flash_attention_bwd_plain(
                q, k, v, o, do.contiguous(), causal=ctx.causal,
                q_offset=ctx.q_offset), None, None)

    saved = layers.rmsnorm, layers.blockwise_attention

    def rms(x, gamma, eps=1e-6):
        return saved[0](x, None, eps) if gamma is None else \
            PlainRMS.apply(x, gamma, eps)

    def attn(q, k, v, *, causal, q_offset=0, block_kv=1024):
        return PlainAttn.apply(q, k, v, causal, int(q_offset))
    layers.rmsnorm, layers.blockwise_attention = rms, attn
    try:
        yield
    finally:
        layers.rmsnorm, layers.blockwise_attention = saved


def _grad_rule(label: str, got: dict, want: dict, rtol: float) -> float:
    """Every gradient leaf finite and within rtol x max|want| of ``want``,
    each leaf alone; returns the worst ratio err / max|want|."""
    from repro_torch.train.tree import flatten
    w = dict(flatten(want))
    worst = 0.0
    for k, g in flatten(got):
        ref = w[k].float()
        scale = ref.abs().max().item()
        assert bool(g.isfinite().all()), f"{label}: gradient {k} not finite"
        assert scale > 0 and math.isfinite(scale), \
            f"{label}: plain gradient {k} is zero or not finite"
        err = (g.float() - ref).abs().max().item()
        worst = max(worst, err / scale)
        assert err <= rtol * scale, \
            (f"{label}: gradient {k}: max|kernel - plain| {err:.3g} > "
             f"{rtol:g} x {scale:.3g}")
    return worst


def _rel_errs(got: dict, truth: dict) -> dict:
    """Each leaf's max|got - truth| / max|truth|."""
    from repro_torch.train.tree import flatten
    t = dict(flatten(truth))
    return {k: (g.float() - t[k].float()).abs().max().item()
            / t[k].float().abs().max().item() for k, g in flatten(got)}


def _bytes_equal(a: dict, b: dict) -> bool:
    from repro_torch.train.tree import flatten
    return all(x.equal(y) for (_, x), (_, y) in zip(flatten(a), flatten(b)))


def train_batch(vocab: int, batch: int, seq: int, step: int = 0) -> dict:
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    return SyntheticLMStream(DataConfig(vocab, seq, batch, seed=0)).batch(step)


def grad_check(torch, device, label: str, cfg, base, loss_for, wrt_of, *,
               batch: int, seq: int, modes, frozen_base: bool) -> None:
    """One training step's loss and gradients (with respect to
    ``wrt_of(base)``; ``loss_for(model, base)`` is the loss), by the
    two-dtype rule (chip_smoke's docstring, phase 10b):

    * float32, the same weights upcast: the kernels (remat='full') against
      the plain oracle (``plain_layers``, remat='full'), every gradient
      within TRAIN_F32_RTOL x max|plain|, each leaf alone, and the loss
      within TRAIN_LOSS_RTOL; the oracle is also the float32 truth below;
    * bfloat16, under each of ``modes``: the loss within TRAIN_LOSS_RTOL
      of the truth's; every gradient's max error against the truth at
      most BF16_VS_PLAIN times the plain bfloat16 oracle's (or than
      BF16_ULP, where that is larger), each leaf alone; the modes against the first by LORA_GRAD_RTOL (byte equality
      printed). Launches asserted for every kernel run; step time (after
      one untimed warm-up step of the same mode), peak allocated bytes and
      (remat='offload') offloaded bytes printed."""
    import dataclasses as dc
    from repro_torch.models import build_model
    from repro_torch.train.step import value_and_grad
    from repro_torch.train.tree import tree_map

    b = train_batch(cfg.vocab_size, batch, seq)
    t = time.perf_counter()
    cfg32 = dc.replace(cfg, dtype="float32")
    base32 = tree_map(lambda x: x.float(), base)
    with plain_layers():
        truth_loss, truth = value_and_grad(
            loss_for(build_model(cfg32, device=device, remat="full"), base32),
            wrt_of(base32), b)
    _reset_train_launches()
    k_loss, k32 = value_and_grad(
        loss_for(build_model(cfg32, device=device, remat="full"), base32),
        wrt_of(base32), b)
    torch.cuda.synchronize()
    _check_launches(f"{label} float32", _train_launches(),
                    expected_train_launches(cfg.n_layers, "full",
                                            frozen_base=
                                            frozen_base))
    del base32
    truth_loss, k_loss = truth_loss.item(), k_loss.item()
    assert abs(k_loss - truth_loss) <= TRAIN_LOSS_RTOL * abs(truth_loss), \
        f"{label} float32: loss {k_loss} against the oracle's {truth_loss}"
    worst = _grad_rule(f"{label} float32", k32, truth, TRAIN_F32_RTOL)
    print(f"train grad check {label} float32 {batch}x{seq} remat=full: loss "
          f"{k_loss:.6f} (oracle {truth_loss:.6f}) max_err/max|plain| "
          f"{worst:.3g} (tol {TRAIN_F32_RTOL:g}); {_phase_s(t)}", flush=True)
    del k32
    torch.cuda.empty_cache()

    t = time.perf_counter()
    with plain_layers():
        p_loss, p16 = value_and_grad(
            loss_for(build_model(cfg, device=device, remat="full"), base),
            wrt_of(base), b)
    plain_err = _rel_errs(p16, truth)
    print(f"train grad check {label} {cfg.dtype} plain oracle remat=full: loss "
          f"{p_loss.item():.6f} (float32 truth {truth_loss:.6f}) "
          f"max_err/max|truth| by leaf {_fmt(plain_err)}; {_phase_s(t)}",
          flush=True)
    del p16
    first = None
    for remat in modes:
        model = build_model(cfg, device=device, remat=remat)
        # warm-up: first-use costs (pinned host blocks for 'offload', the
        # allocator's pools) stay out of the timed step
        value_and_grad(loss_for(model, base), wrt_of(base), b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_train_launches()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(loss_for(model, base), wrt_of(base), b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = _train_launches()
        peak = torch.cuda.max_memory_allocated()
        _check_launches(f"{label} remat={remat}", launches,
                        expected_train_launches(cfg.n_layers, remat,
                                                frozen_base=
                                                frozen_base))
        loss = loss.item()
        assert math.isfinite(loss) and \
            abs(loss - truth_loss) <= TRAIN_LOSS_RTOL * abs(truth_loss), \
            f"{label} remat={remat}: loss {loss} against {truth_loss}"
        errs = _rel_errs(grads, truth)
        for k, e in errs.items():
            lim = BF16_VS_PLAIN * max(plain_err[k], BF16_ULP)
            assert math.isfinite(e) and e <= lim, \
                (f"{label} remat={remat}: gradient {k} is {e:.4g} of "
                 f"max|truth| from the float32 truth, the plain {cfg.dtype} "
                 f"oracle {plain_err[k]:.4g} (limit {lim:.4g})")
        moved = ""
        if remat == "offload":
            got = _check_offload(cfg, batch, seq)
            moved = (f" offloaded_bytes {got['offloaded']} "
                     f"reloaded_bytes {got['reloaded']}")
        same = ""
        if first is None:
            first = (remat, loss, grads)
        else:
            vs = _grad_rule(f"{label} remat={remat} vs {first[0]}", grads,
                            first[2], LORA_GRAD_RTOL)
            same = (f" vs_remat_{first[0]} byte_equal "
                    f"{loss == first[1] and _bytes_equal(grads, first[2])} "
                    f"max_err/max|{first[0]}| {vs:.3g}")
        print(f"train grad check {label} {cfg.dtype} {batch}x{seq} remat={remat}:"
              f" step_s {dt:.3f} loss {loss:.6f} max_err/max|truth| by leaf "
              f"{_fmt(errs)} (limit {BF16_VS_PLAIN:g}x the plain oracle's) "
              f"peak_allocated_bytes {peak}{moved} launches {launches}{same}",
              flush=True)
        del model, grads
    del truth


def _fmt(errs: dict) -> str:
    return "{" + ", ".join(f"{k}: {v:.4f}" for k, v in errs.items()) + "}"


def _phase_s(t0: float) -> str:
    return f"{time.perf_counter() - t0:.2f} s"


def supervised_run(torch, device, *, profile: bool) -> tuple[dict, object]:
    """The slice's main path, through repro_torch.launch.train's own
    functions: llama-7b with LoRA, remat='offload', SUPERVISED's batch,
    sequence, steps and checkpoint cadence. A step_fn wrapper raises once
    before each step of SUPERVISED's faults; before raising at a step that
    follows no checkpoint it overwrites the live adapters and optimizer
    state with NaN, as a step that fails half-way through an update would.
    The Supervisor restores the last checkpoint each time and goes on; the
    final adapters and optimizer state must be byte-equal to an
    uninterrupted run's. Then one step under remat='full' at the same
    shape (peak HBM and step time beside 'offload'). Returns the launches
    of the supervised run and the Run (its base weights)."""
    import tempfile
    from repro_torch.launch import train as T
    from repro_torch.models import build_model
    from repro_torch.models.lora import make_lora_loss
    from repro_torch.train.step import value_and_grad
    from repro_torch.train.tree import flatten

    S = SUPERVISED
    tmp = tempfile.TemporaryDirectory(prefix="repro_torch_train_")
    argv = ["--arch", TRAIN_ARCH, "--lora", "--remat", "offload",
            "--batch", str(S["batch"]), "--seq", str(S["seq"]),
            "--steps", str(S["steps"]), "--save-every", str(S["save_every"]),
            "--device", str(device)]
    t = time.perf_counter()
    args = T.parse_args(argv + ["--ckpt-dir", os.path.join(tmp.name, "a")])
    r = T.setup(args)
    torch.cuda.synchronize()
    _phase("supervised run: setup (base weights drawn on the card)", t)
    left = set(S["faults"])
    step_s = []

    def faulty(state, batch):
        nxt = int(state["step"]) + 1
        if nxt in left:
            left.discard(nxt)
            if (nxt - 1) % S["save_every"]:
                for _, leaf in flatten({"p": state["params"],
                                        "o": state["opt"]}):
                    if leaf.is_floating_point():
                        leaf.fill_(float("nan"))
            raise RuntimeError(f"injected fault before step {nxt}")
        t0 = time.perf_counter()
        out = r.step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    def log(msg):
        print(f"supervised run: {msg}", flush=True)

    _reset_train_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state, report, losses = T.run(r, args, step_fn=faulty, log=log)
    torch.cuda.synchronize()
    launches = _train_launches()
    peak = torch.cuda.max_memory_allocated()
    wall = time.perf_counter() - t
    ckpt = lambda n: (n - 1) - (n - 1) % S["save_every"]   # noqa: E731
    want = [e for n in S["faults"]
            for e in (f"fail@{n - 1}:RuntimeError", f"restored@{ckpt(n)}")]
    assert not left and report.restarts == len(S["faults"]) and \
        [e for e in report.history if e.startswith(("fail", "restored"))] \
        == want, report.history
    n_run = len(step_s)
    assert n_run == S["steps"] + sum(n - 1 - ckpt(n) for n in S["faults"]), \
        (n_run, report.history)
    _check_launches("supervised run", launches,
                    expected_train_launches(r.model.cfg.n_layers, "offload",
                                            frozen_base=True), n_run)
    assert_flash_bwd_on_tensor_cores()
    off = _check_offload(r.model.cfg, S["batch"], S["seq"], n_run)
    print(f"supervised run {TRAIN_ARCH} lora remat=offload "
          f"{S['batch']}x{S['seq']}: {n_run} steps run, restarts "
          f"{report.restarts}, history {report.history}; wall_s {wall:.2f} "
          f"step_s {[round(x, 3) for x in step_s]} peak_allocated_bytes "
          f"{peak} offloaded_bytes_a_step {off['offloaded'] // n_run} "
          f"reloaded_bytes_a_step {off['reloaded'] // n_run} losses "
          f"{[round(x, 5) for x in losses]} launches {launches}", flush=True)
    assert all(math.isfinite(x) for x in losses)

    t = time.perf_counter()
    args_b = T.parse_args(argv + ["--ckpt-dir", os.path.join(tmp.name, "b")])
    clean, report_b, losses_b = T.run(r, args_b, log=lambda m: None)
    torch.cuda.synchronize()
    same = _bytes_equal(state, clean)
    print(f"supervised run: uninterrupted {report_b.steps_run} steps in "
          f"{time.perf_counter() - t:.2f} s, losses "
          f"{[round(x, 5) for x in losses_b]}; final adapters and optimizer "
          f"state byte-equal to the faulted run: {same}", flush=True)
    assert same, "the resumed run's final state differs from the " \
        "uninterrupted run's"
    tmp.cleanup()

    model = build_model(r.model.cfg, device=device, remat="full")
    b = train_batch(r.model.cfg.vocab_size, S["batch"], S["seq"])
    for label, m in (("full", model), ("offload", r.model)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        value_and_grad(make_lora_loss(m, r.base), clean["params"], b)
        torch.cuda.synchronize()
        print(f"train step remat={label} {S['batch']}x{S['seq']}: step_s "
              f"{time.perf_counter() - t0:.3f} (loss and gradients, no "
              f"update) peak_allocated_bytes "
              f"{torch.cuda.max_memory_allocated()}", flush=True)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            value_and_grad(make_lora_loss(r.model, r.base), clean["params"],
                           b)
            torch.cuda.synchronize()
        copies, kernels = {"HtoD": [], "DtoH": []}, []
        for e in prof.events():
            if "cuda" not in str(getattr(e, "device_type", "")).lower():
                continue
            span = (e.time_range.start, e.time_range.end)
            kind = next((c for c in copies if c in e.name), None)
            if kind:
                copies[kind].append(span)
            elif "Memset" not in e.name and "Memcpy" not in e.name:
                kernels.append(span)
        kernels.sort()
        for kind, spans in copies.items():
            ms = sum(b - a for a, b in spans) / 1e3
            overl = sum(any(ka < b and a < kb for ka, kb in kernels)
                        for a, b in spans)
            print(f"profile train step remat=offload: {kind} {len(spans)} "
                  f"copies, device_ms {ms:.2f}, {overl} overlap a kernel",
                  flush=True)
        profile_kernels(prof, f"train step remat=offload {S['batch']}x"
                              f"{S['seq']}")
    del model
    return launches, r


def full_param_run(torch, device) -> None:
    """llama-7b width, FULL_PARAM's layers, bfloat16, AdamW over every
    leaf: each leaf's gradient of the first step by the two-dtype rule
    (``grad_check``, remat None), then FULL_PARAM's steps through make_train_step on that one batch, so that
    a fall of the loss is the optimizer's and not the data's: the loss must
    fall at every step. dγ goes through rmsnorm_bwd (launches
    asserted)."""
    import dataclasses as dc
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import init_train_state, make_train_step

    P = FULL_PARAM
    cfg = dc.replace(get_arch(TRAIN_ARCH), n_layers=P["layers"])
    model = build_model(cfg, device=device)
    opt = AdamW(lr=P["lr"])
    state = init_train_state(model, torch.Generator(device=device)
                             .manual_seed(0), opt)
    b = train_batch(cfg.vocab_size, P["batch"], P["seq"])
    grad_check(torch, device, f"full-parameter {cfg.name} L={cfg.n_layers}",
               cfg, state["params"], lambda m, base: m.loss, lambda p: p,
               batch=P["batch"], seq=P["seq"], modes=(None,),
               frozen_base=False)
    step_fn = make_train_step(model, opt)
    losses, times = [], []
    _reset_train_launches()
    for i in range(P["steps"]):
        t0 = time.perf_counter()
        state, met = step_fn(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(met["loss"].item())
    launches = _train_launches()
    _check_launches("full-parameter steps", launches,
                    expected_train_launches(cfg.n_layers, None,
                                            frozen_base=False),
                    P["steps"])
    print(f"full-parameter steps: losses {[round(x, 5) for x in losses]} "
          f"step_s {[round(x, 3) for x in times]} launches {launches}",
          flush=True)
    assert all(math.isfinite(x) for x in losses) and \
        all(b < a for a, b in zip(losses, losses[1:])), \
        f"the full-parameter loss did not fall: {losses}"


def train_phase(torch, device, *, profile: bool) -> dict:
    """Phase 10: the gradient check, the supervised run and the
    full-parameter run; frees every model before it returns the
    supervised run's launches."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.lora import lora_init, make_lora_loss

    cfg = get_arch(TRAIN_ARCH)
    t = time.perf_counter()
    base = build_model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(0))
    adapters = lora_init(torch.Generator(device=device).manual_seed(1), base)
    gen = torch.Generator(device=device).manual_seed(2)
    for ad in adapters.values():          # B nonzero: with B = 0, dA is 0
        ad["B"] = torch.randn(ad["B"].shape, generator=gen,
                              device=device) * LORA_B_SCALE
    torch.cuda.synchronize()
    _phase("train grad check: base weights and adapters", t)
    t = time.perf_counter()
    grad_check(torch, device, f"{cfg.name} lora L={cfg.n_layers}", cfg, base,
               make_lora_loss, lambda _: adapters, batch=GRAD_CHECK[0],
               seq=GRAD_CHECK[1], modes=REMAT_ORDER, frozen_base=True)
    _phase("train grad check", t)
    del base, adapters
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    launches, r = supervised_run(torch, device, profile=profile)
    _phase("supervised run", t)
    del r
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    full_param_run(torch, device)
    gc.collect()
    torch.cuda.empty_cache()
    _phase("full-parameter run", t)
    return launches


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if "--ab-worker" in argv:
        return ab_worker(argv[argv.index("--ab-worker") + 2])
    if "--ab-prefill" in argv:
        return ab_prefill(argv[argv.index("--ab-prefill") + 1])
    if "--ab-train-worker" in argv:
        return ab_train_worker()
    if "--ab-train" in argv:
        return ab_train(argv[argv.index("--ab-train") + 1])
    from repro_torch.configs import get_arch
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
        for line in ptxas_lines(log):       # ptxas: registers and spills
            print(f"build {name}: {line}", flush=True)
    _phase("build", t)

    t = time.perf_counter()
    rms = kernel_phase(torch, device)
    fa = flash_phase(torch, device)
    gmm = gmm_phase(torch, device)
    flash_112_phase(torch, device)
    scans = scan_phase(torch, device)
    print("kernels: rmsnorm flash_attention moe_gmm ssd_scan wkv6",
          flush=True)
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
    hw = measure_hardware(torch, device, tr.tg)
    _phase("hardware model", t)

    t = time.perf_counter()
    profiled = {} if "--profile" in argv else None
    launches, runs = run_main_path(torch, device, tr, res, cap, inputs,
                                   n_rms=2 * MAIN_LAYERS + 1,
                                   profile=profiled)
    _phase("prefill path", t)
    if launches["rmsnorm"] == 0:
        raise AssertionError("the prefill path launched no rmsnorm kernel")
    sims = [("prefill", res, runs, profiled or {})]
    del inputs, tr

    for T in LORA_TOKENS:
        t = time.perf_counter()
        ltr, lres, lcap = build_lora_path(T)
        linputs = inputs_from_reference(ltr.make_inputs(seed=0),
                                        device=device)
        print(f"LoRA path: llama-7b width, {LORA_LAYERS} layers, T={T}, "
              f"float16; {len(ltr.tg)} task vertices, {len(lres.memgraph)} "
              f"memgraph vertices; HBM budget {lcap} B; offloads "
              f"{lres.n_offloads} reloads {lres.n_reloads}; "
              f"{sum(v.numel() * v.element_size() for v in linputs.values())}"
              f" B pinned inputs", flush=True)
        _phase(f"LoRA T={T} trace, plan and inputs", t)
        t = time.perf_counter()
        lprofiled = {} if "--profile" in argv and T == 2048 else None
        lruns = run_lora_path(torch, device, ltr, lres, lcap, linputs,
                              profile=lprofiled)
        _phase(f"LoRA T={T} path", t)
        sims.append((f"lora T={T}", lres, lruns, lprofiled or {}))
        del ltr, linputs
        gc.collect()
        torch.cuda.empty_cache()
    for label, plan_res, plan_runs_, busy in sims:
        sim_vs_measured(label, plan_res, hw, plan_runs_, busy)
    del sims, runs, res
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    rms_bwd = rmsnorm_bwd_phase(torch, device)
    fa_bwd = flash_bwd_phase(torch, device)
    gc.collect()
    torch.cuda.empty_cache()
    _phase("training kernels", t)
    t = time.perf_counter()
    trained = train_phase(torch, device, profile="--profile" in argv)
    _phase("training path", t)

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
    run_serving(torch, device, model, params, prompts,
                profile="--profile" in argv)
    _phase("serving path", t)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, params = build_serving(torch, device, arch=get_arch(MOE_ARCH))
    cfg = model.cfg
    print(f"MoE serving path: {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts of {cfg.d_ff}, top-"
          f"{cfg.top_k}, bfloat16 (router float32), "
          f"{sum(t.numel() for t in _leaves(params))} parameters "
          f"({sum(t.numel() * t.element_size() for t in _leaves(params))} B)"
          f"; peak_allocated_bytes after the draw "
          f"{torch.cuda.max_memory_allocated()}", flush=True)
    _phase("MoE serving model", t)
    t = time.perf_counter()
    served = run_serving(torch, device, model, params,
                         serving_traffic(cfg.vocab_size),
                         profile="--profile" in argv)
    _phase("MoE serving path", t)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    recurrent = {}
    for arch in RECURRENT_ARCHS:
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model, params = build_recurrent(torch, device, get_arch(arch))
        cfg = model.cfg
        print(f"recurrent path: {cfg.name}, {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, bfloat16, "
              f"{sum(t.numel() for t in _leaves(params))} parameters "
              f"({sum(t.numel() * t.element_size() for t in _leaves(params))}"
              f" B); peak_allocated_bytes after the draw "
              f"{torch.cuda.max_memory_allocated()}", flush=True)
        _phase(f"{cfg.name} model", t)
        t = time.perf_counter()
        recurrent.update(run_recurrent(torch, device, model, params,
                                       profile="--profile" in argv))
        _phase(f"{cfg.name} recurrent path", t)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        decode_check(torch, device, get_arch(arch))
        gc.collect()
        torch.cuda.empty_cache()
        _phase(f"{arch} float32 decode check", t)

    records = [
        dict(name="rmsnorm", route="cuda",
             source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/kernel.py:13",
             launches=served["rmsnorm"], **rms),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:23",
             launches=served["flash_attention"],
             launches_tc=served["flash_attention_tc"],
             launches_scalar=served["flash_attention_scalar"], **fa),
        dict(name="moe_gmm", route="cuda",
             source="src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
             replaces="src/repro/kernels/moe_gmm/kernel.py:19",
             launches=served["moe_gmm"],
             launches_wgmma=served["moe_gmm_wgmma"],
             launches_mma=served["moe_gmm_mma"], **gmm),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:19",
             launches=recurrent["ssd_scan"],
             kernel_launches=recurrent["ssd_scan_kernel"],
             **scans["ssd_scan"]),
        dict(name="wkv6", route="cuda",
             source="src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
             replaces="src/repro/kernels/rwkv6/kernel.py:18",
             launches=recurrent["wkv6"],
             kernel_launches=recurrent["wkv6_kernel"], **scans["wkv6"]),
        dict(name="rmsnorm_bwd", route="cuda",
             source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/kernel.py:13",
             note="the VJP of the kernel at replaces; no TPU kernel "
                  "computes it",
             launches=trained["rmsnorm_bwd"],
             kernel_launches=trained["rmsnorm_bwd_kernel"], **rms_bwd),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:23",
             note="the VJP of the kernel at replaces; no TPU kernel "
                  "computes it",
             launches=trained["flash_attention_bwd"],
             kernel_launches=trained["flash_attention_bwd_kernel"],
             **fa_bwd)]
    _phase("total", t_all)
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
