"""Variants of the flash-attention backward, compiled side by side from
``csrc/flash_attention_bwd.cu`` and timed in turns on the card.

Each variant is the source with a few text substitutions (:data:`VARIANTS`):
other designs tried for the kernel, and diagnostics that drop one part of
the work (their results are wrong and are not checked) to show what that
part costs. Every variant is built with :data:`repro_torch.kernels.build.
NVCC_FLAGS` into ``build/bwd_variants/``, loaded through the kernel's C
entry point, held against ``flash_attention_bwd_plain`` (not the
diagnostics) within ``gradient_limit`` and for equal bytes on a second
call, then timed at llama-7b's training shape (4 x 4096, 32 heads of 128,
causal, bfloat16): the median of 10 CUDA-event timings with the L2 cache
flushed, three rounds in alternating order, and each launch's device time
from ``torch.profiler``. ``--with ROOT`` adds another checkout's
``flash_attention_bwd.cu`` (same C entry point) as the variant
``other``. Run on the card from the repository root::

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.bwd_variants
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import statistics
import subprocess
import sys

__all__ = ["VARIANTS", "variant_source", "main"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention_bwd.cu"
SHAPE = (4, 4096, 4096, 32, 32, 128, True, 0)   # B, Sq, Skv, Hq, Hkv, Dh, causal, q_offset
CHECKS = [(1, 200, 200, 4, 4, 128, True, 0), (1, 512, 512, 32, 8, 128, True, 0),
          (1, 100, 300, 4, 4, 112, True, 200), (2, 64, 256, 8, 2, 64, False, 0),
          (1, 64, 256, 4, 2, 32, True, 192)]

_REGS = ("constexpr int PRODUCER_REGS = 40;\nconstexpr int CONSUMER_REGS = 232;",
         "constexpr int PRODUCER_REGS = 24;\nconstexpr int CONSUMER_REGS = 240;")
_QT_MAJOR = [
    ("""  int qt = blockIdx.x % n_qt;
  if (p.causal) qt = n_qt - 1 - qt;
  const int h = (blockIdx.x / n_qt) % p.hq;
  const int b = (blockIdx.x / n_qt) / p.hq;""",
     """  int qt = blockIdx.x / (p.hq * p.batch);
  if (p.causal) qt = n_qt - 1 - qt;
  const int h = (blockIdx.x % (p.hq * p.batch)) % p.hq;
  const int b = (blockIdx.x % (p.hq * p.batch)) / p.hq;"""),
    ("""  const int kb = blockIdx.x % n_kb;
  const int hk = (blockIdx.x / n_kb) % p.hkv;
  const int b = (blockIdx.x / n_kb) / p.hkv;""",
     """  const int kb = blockIdx.x / (p.hkv * p.batch);
  const int hk = (blockIdx.x % (p.hkv * p.batch)) % p.hkv;
  const int b = (blockIdx.x % (p.hkv * p.batch)) / p.hkv;""")]
_TURNS = [
    ("__device__ __forceinline__ void init_ring(",
     """__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\\n" :: "r"(2 - wg) : "memory");
}

__device__ __forceinline__ void init_ring("""),
    ("""  for (int i = 0; i < n_steps; ++i) {
    const int st = i % KV_STAGES;""",
     """  if (wg == 1) turn_pass(wg);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % KV_STAGES;"""),
    ("""      pin(dp);
      wg_fence();
      issue_nt<T, DH, KV_BK * 128, KV_BQ * 128>(s, k_at, q_at);
      issue_nt<T, DH, KV_BK * 128, KV_BQ * 128>(dp, v_at, do_at);
      wg_commit();""",
     """      pin(dp);
      turn_wait(wg);
      wg_fence();
      issue_nt<T, DH, KV_BK * 128, KV_BQ * 128>(s, k_at, q_at);
      issue_nt<T, DH, KV_BK * 128, KV_BQ * 128>(dp, v_at, do_at);
      wg_commit();
      turn_pass(wg);"""),
    ("""      wg_fence();
      issue_rs<T, DH, KV_BQ>(dv, ph, pl, do_at);
      issue_rs<T, DH, KV_BQ>(dk, fh, fl, q_at);
      wg_commit();""",
     """      turn_wait(wg);
      wg_fence();
      issue_rs<T, DH, KV_BQ>(dv, ph, pl, do_at);
      issue_rs<T, DH, KV_BQ>(dk, fh, fl, q_at);
      wg_commit();
      turn_pass(wg);"""),
    ("""      pin(fl);
    }
    mbar_arrive(&empty[st]);""",
     """      pin(fl);
    } else {
      turn_wait(wg);
      turn_pass(wg);
      turn_wait(wg);
      turn_pass(wg);
    }
    mbar_arrive(&empty[st]);""")]
_HI_ONLY = ("// (a) Di and dQ: one block a (b, query head, 128-row query block)",
            """// (a) Di and dQ: one block a (b, query head, 128-row query block)
template <typename T, int DH, int B_ROWS>
__device__ __forceinline__ void issue_rs_hi(float (&d)[DH / 2],
                                            const uint32_t (&ph)[16],
                                            const uint32_t (&pl)[16],
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<T, DH>(d, ph + 4 * kk,
                    smem_desc(b + kk * 16 * 128, B_ROWS * 128, 1024));
}""")
_NO_LO = [_HI_ONLY] + [
    (f"issue_rs<T, DH, {rows}>({acc}", f"issue_rs_hi<T, DH, {rows}>({acc}")
    for rows, acc in (("KV_BQ", "dv"), ("KV_BQ", "dk"), ("DQ_BK", "dq, fh, fl, kv_at + sp"),
                      ("DQ_BK", "dq, fh, fl, kv_at + sl"))]
_NO_SCORES = [
    ("""      kv_scores(s, dp, p, q0, kvrow, kv_lo, lse2_s + st * KV_BQ,
                di_s + st * KV_BQ, lane);""", ""),
    ("      dq_scores(s, dp, p, t * DQ_BK, qrow, row_lo, lse2, di, lane);", "")]

_FRAG_BUFFER = [("""      dq_scores(s, dp, p, t * DQ_BK, qrow, row_lo, lse2, di, lane);
      wg_wait<0>();                      // dS.K of tile t-1
      pin(dq);
      pin(fh);
      pin(fl);
      mbar_arrive(&empty[sp]);
      a_fragments<T>(dp, fh, fl);""",
                  """      dq_scores(s, dp, p, t * DQ_BK, qrow, row_lo, lse2, di, lane);
      uint32_t gh[16], gl[16];
      a_fragments<T>(dp, gh, gl);
      wg_wait<0>();                      // dS.K of tile t-1
      pin(dq);
      pin(fh);
      pin(fl);
      mbar_arrive(&empty[sp]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        fh[j] = gh[j];
        fl[j] = gl[j];
      }""")]
_NO_FIRST = [("""      issue_nt<T, DH, KV_BK * 128, KV_BQ * 128>(s, k_at, q_at);
      issue_nt<T, DH, KV_BK * 128, KV_BQ * 128>(dp, v_at, do_at);""", "")]

_MASK_PER_SCORE = [
    ("""  if (edge) dq_scores_t<true>(s, dp, p, k0, qrow, lse2, di, lane);
  else dq_scores_t<false>(s, dp, p, k0, qrow, lse2, di, lane);""",
     """  if (edge || !edge) dq_scores_t<true>(s, dp, p, k0, qrow, lse2, di, lane);"""),
    ("""  if (edge) kv_scores_t<true>(s, dp, p, q0, kvrow, lse2, di, lane);
  else kv_scores_t<false>(s, dp, p, q0, kvrow, lse2, di, lane);""",
     """  if (edge || !edge) kv_scores_t<true>(s, dp, p, q0, kvrow, lse2, di, lane);""")]

# name -> substitutions (old, new), each old string found once in SOURCE.
# Names starting "diag_" drop work: their results are wrong.
VARIANTS: dict[str, list[tuple[str, str]]] = {
    "as_built": [],
    "mask_per_score": _MASK_PER_SCORE,   # every pair tested against the mask
    "qt_major_grid": _QT_MAJOR,          # the block index slowest
    "kv_stages_2": [("constexpr int KV_STAGES = 3;", "constexpr int KV_STAGES = 2;")],
    "dq_stages_3": [("constexpr int DQ_STAGES = 4;", "constexpr int DQ_STAGES = 3;")],
    "regs_24_240": [_REGS],
    "ping_pong": _TURNS,                 # (b)'s warpgroups issue in turns
    "dq_frag_buffer": _FRAG_BUFFER,      # (a) converts dS before the wait
    "diag_no_lo": _NO_LO,                # bf16 P and dS issued once
    "diag_no_scores": _NO_SCORES,        # no exponentials, masks, dS
    "diag_no_lo_no_scores": _NO_LO + _NO_SCORES,
    "diag_no_kv_scores_products": _NO_FIRST,   # (b) without S^T, dP^T
}


def variant_source(name: str, text: str | None = None) -> str:
    """The kernel source of one variant."""
    text = SOURCE.read_text() if text is None else text
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old[:60]!r} is not in the "
                             f"source exactly once")
        text = text.replace(old, new)
    return text


def _compile(name: str, text: str, out: pathlib.Path):
    from ..build import NVCC_FLAGS, _nvcc
    cu = out / f"{name}.cu"
    cu.write_text(text)
    so = out / f"lib{name}.so"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(so),
                        str(cu)], capture_output=True, text=True)
    return name, (so if r.returncode == 0 else None), r.stdout + r.stderr


def main(argv: list[str]) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..build import build_dir
    from .ops import (_DTYPE_CODE, flash_attention, flash_attention_bwd_plain,
                      gradient_limit)
    if not torch.cuda.is_available():
        print("bwd_variants: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    out = build_dir().parent / "bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    todo = [(n, variant_source(n)) for n in VARIANTS]
    if "--with" in argv:
        other = pathlib.Path(argv[argv.index("--with") + 1]).resolve()
        todo.append(("other", (other / "src/repro_torch/kernels/flash_attention"
                               "/csrc/flash_attention_bwd.cu").read_text()))
    with concurrent.futures.ThreadPoolExecutor(len(todo)) as ex:
        built = list(ex.map(lambda nt: _compile(*nt, out), todo))
    fns = {}
    for name, so, log in built:
        if so is None:
            print(f"{name}: build failed\n{log[-2000:]}", flush=True)
            return 1
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln]
        print(f"{name}: ptxas spills {sorted(set(s.split(',', 1)[1] for s in spills if ',' in s))}",
              flush=True)
        fn = ctypes.CDLL(str(so)).flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def call(fn, q, k, v, o, do, lse, causal, off):
        B, Sq, Hq, Dh = q.shape
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        di = torch.empty(B, Hq, Sq, device=dev)
        st = (ctypes.c_int64 * 24)(*(x for t in (q, k, v, o, do, dq, dk, dv)
                                     for x in t.stride()[:3]))
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), ctypes.addressof(st), B, Sq,
                 k.shape[1], Hq, k.shape[2], Dh, off, int(causal),
                 _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return dq, dk, dv

    def inputs(case, dt, gen):
        B, Sq, Skv, Hq, Hkv, Dh, causal, off = case
        q, do = (torch.randn(B, Sq, Hq, Dh, generator=gen, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, Skv, Hkv, Dh, generator=gen, device=dev).to(dt)
                for _ in range(2))
        lse = torch.empty(B, Hq, Sq, device=dev)
        o = flash_attention(q, k, v, causal=causal, q_offset=off, lse=lse)
        return q, k, v, o, do, lse

    gen = torch.Generator(device=dev).manual_seed(1)
    for case in CHECKS:
        for dt in (torch.bfloat16, torch.float16):
            q, k, v, o, do, lse = inputs(case, dt, gen)
            want = flash_attention_bwd_plain(q, k, v, o, do, causal=case[6],
                                             q_offset=case[7])
            name = str(dt).removeprefix("torch.")
            for vn, fn in fns.items():
                if vn.startswith("diag_"):
                    continue
                got = call(fn, q, k, v, o, do, lse, case[6], case[7])
                again = call(fn, q, k, v, o, do, lse, case[6], case[7])
                r = max(((a.float() - b.float()).abs()
                         / gradient_limit(b, name)).max().item()
                        for a, b in zip(got, want))
                if not (r <= 1.0 and all(torch.equal(a, b)
                                         for a, b in zip(got, again))):
                    print(f"{vn} fails at {case} {name}: err/limit {r:.3g}",
                          flush=True)
                    return 1
    print("every variant but the diagnostics within gradient_limit, "
          "byte-equal on a second call", flush=True)

    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=dev)
    args = inputs(SHAPE, torch.bfloat16, torch.Generator(device=dev).manual_seed(0))
    causal, off = SHAPE[6], SHAPE[7]

    def once(fn):
        flush.zero_()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call(fn, *args, causal, off)
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    names = list(fns)
    ms = {n: [] for n in names}
    for rnd in range(3):
        for n in (names if rnd % 2 == 0 else names[::-1]):
            once(fns[n])
            ms[n].append(statistics.median(once(fns[n]) for _ in range(10)))
    for n in names:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                flush.zero_()
                call(fns[n], *args, causal, off)
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
            if "attn_bwd" in e.key and e.count:
                key = e.key.split("(anonymous namespace)::")[1].split("<")[0]
                parts[key] = round(t / e.count / 1e3, 4)
        print(f"variant {n} at {SHAPE} bf16: median {statistics.median(ms[n]):.4f} ms "
              f"(rounds {[round(x, 4) for x in ms[n]]}) by launch {parts}",
              flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
