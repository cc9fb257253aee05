"""Trace model configs into TASKGRAPHs (paper §4: "TURNIP is agnostic as to
how the TASKGRAPH is created" — this module plays the FlexFlow/Alpa role).

Two workloads, matching the paper's evaluation:

* :func:`trace_prefill` — first-token inference (paper §8 task 1): per layer,
  per device, head-sliced q/k/v projections, per-(head-group × q-row-block)
  attention fragments (the 128·n² offloadable intermediates of the paper's
  introduction), row-sliced output projections combined with a *streaming*
  reduction (§B), column-sliced MLP. Weights are INPUT vertices → they
  stream from host RAM exactly like the paper's weight offload.
* :func:`trace_lora_train` — LoRA fwd+bwd (paper §8 task 2): rank-r adapters
  on Q/K/V and the FFN up-projection, frozen base weights, activation
  checkpointing (only layer inputs saved; each layer's internals are
  re-traced in the backward section, as the paper does). The backward math
  is *exact* — validated against ``jax.grad`` of an identical reference
  network in the reference package's test suite.

Head-batched attention keeps per-head softmax semantics while letting one
task cover ``head_group`` heads ([hg, qb, S] tensors), so vertex counts stay
tractable at paper scale without under-counting the quadratic memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np

from .taskgraph import OpKind, TaskGraph, TensorSpec
from ..configs.base import ArchConfig

__all__ = ["TraceConfig", "Traced", "trace_prefill", "trace_lora_train"]


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_devices: int = 1
    head_group: int = 4          # heads fused per attention task (exact math)
    q_block: int = 1024          # q rows per attention task
    mlp_slices: int = 4          # column slices of the FFN per device
    lora_rank: int = 16
    lora_alpha: float = 16.0
    dtype: str = "float32"       # float16 for memory-faithful benchmarks


@dataclasses.dataclass
class Traced:
    tg: TaskGraph
    weight_tids: list[int]
    input_tid: int
    grad_tids: dict[str, int]
    meta: dict[str, Any]

    def make_inputs(self, seed: int = 0,
                    scale: float = 0.02) -> dict[int, np.ndarray]:
        """Random host-store contents for every INPUT vertex."""
        rng = np.random.default_rng(seed)
        out: dict[int, np.ndarray] = {}
        for tid, v in self.tg.vertices.items():
            if v.kind == OpKind.INPUT:
                if v.params.get("fill") == "ones":
                    out[tid] = np.ones(v.out.shape, v.out.np_dtype)
                elif v.params.get("fill") == "zeros":
                    out[tid] = np.zeros(v.out.shape, v.out.np_dtype)
                else:
                    out[tid] = (rng.standard_normal(v.out.shape) *
                                scale).astype(v.out.np_dtype)
        return out


class _Tracer:
    """Shared emission helpers over a TaskGraph."""

    def __init__(self, cfg: ArchConfig, tc: TraceConfig):
        self.cfg = cfg
        self.tc = tc
        self.tg = TaskGraph()
        self.dt = tc.dtype
        self.weights: list[int] = []

    # ---- emission helpers -------------------------------------------------
    def w(self, device: int, shape, name: str) -> int:
        tid = self.tg.add_input(device, TensorSpec(tuple(shape), self.dt),
                                name=name)
        self.weights.append(tid)
        return tid

    def op(self, device, op, inputs, shape, *, flops=0.0, name="",
           **params) -> int:
        return self.tg.add_compute(
            device, tuple(inputs), TensorSpec(tuple(shape), self.dt), op=op,
            flops=float(flops), params=params, name=name)

    def bcast(self, x: int, device: int) -> int:
        """Value of x on `device` (transfer vertex if needed)."""
        if self.tg.vertices[x].device == device:
            return x
        return self.tg.add_transfer(device, x,
                                    name=f"bc{ x }→d{device}")

    def reduce_parts(self, parts: list[int], device: int, name: str) -> int:
        """Streaming sum of partial results on `device` (paper §B)."""
        moved = [self.bcast(p, device) for p in parts]
        if len(moved) == 1:
            return moved[0]
        return self.tg.add_reduce(device, moved, streaming=True, name=name)


def _layer_forward(t: _Tracer, x: int, l: int, weights: dict, *,
                   lora: bool, saved: dict | None = None) -> int:
    """Emit one transformer layer; returns the output tid. ``weights`` maps
    names to already-created weight tids (so the backward re-trace reuses
    them). ``saved`` collects intermediate tids for the backward pass."""
    cfg, tc, tg = t.cfg, t.tc, t.tg
    G = tc.n_devices
    S = t.meta_S
    d = cfg.d_model
    H = cfg.n_heads
    dh = cfg.d_head
    hg = min(tc.head_group, H // G) or 1
    J = (H // G) // hg                      # head-groups per device
    hgw = hg * dh
    r = tc.lora_rank
    s_lora = tc.lora_alpha / r
    QB = max(1, S // tc.q_block)
    qb = S // QB
    sv = saved if saved is not None else {}

    # norm 1 + broadcast
    n1_0 = t.op(0, "rmsnorm", (x, weights["g1"]), (S, d),
                flops=5 * S * d, name=f"L{l}.n1")
    sv["n1"] = n1_0
    n1 = {g: t.bcast(n1_0, g) for g in range(G)}
    sv["n1_dev"] = n1

    att_parts = []
    sv["attn"] = {}
    for g in range(G):
        for j in range(J):
            wq, wk, wv, wo = (weights[f"wq{g}.{j}"], weights[f"wk{g}.{j}"],
                              weights[f"wv{g}.{j}"], weights[f"wo{g}.{j}"])
            a = sv["attn"][(g, j)] = {}
            mm = 2 * S * d * hgw
            q = t.op(g, "matmul", (n1[g], wq), (S, hgw), flops=mm,
                     name=f"L{l}.q{g}.{j}")
            k = t.op(g, "matmul", (n1[g], wk), (S, hgw), flops=mm,
                     name=f"L{l}.k{g}.{j}")
            v = t.op(g, "matmul", (n1[g], wv), (S, hgw), flops=mm,
                     name=f"L{l}.v{g}.{j}")
            if lora:
                for nm, base in (("q", q), ("k", k), ("v", v)):
                    A = weights[f"A{nm}{l}"]
                    B = weights[f"B{nm}{g}.{j}"]
                    t1 = t.op(g, "matmul_t", (n1[g], A), (S, r),
                              flops=2 * S * d * r, name=f"L{l}.{nm}lA{g}.{j}")
                    t2 = t.op(g, "matmul_t", (t1, B), (S, hgw),
                              flops=2 * S * r * hgw,
                              name=f"L{l}.{nm}lB{g}.{j}")
                    t2s = t.op(g, "scale", (t2,), (S, hgw), alpha=s_lora,
                               name=f"L{l}.{nm}ls{g}.{j}")
                    new = t.op(g, "add", (base if nm != "q" else q, t2s),
                               (S, hgw), name=f"L{l}.{nm}+{g}.{j}")
                    a[f"t1{nm}"] = t1
                    if nm == "q":
                        q = new
                    elif nm == "k":
                        k = new
                    else:
                        v = new
            q3 = t.op(g, "split_heads", (q,), (hg, S, dh), n_heads=hg,
                      name=f"L{l}.q3{g}.{j}")
            k3 = t.op(g, "split_heads", (k,), (hg, S, dh), n_heads=hg,
                      name=f"L{l}.k3{g}.{j}")
            v3 = t.op(g, "split_heads", (v,), (hg, S, dh), n_heads=hg,
                      name=f"L{l}.v3{g}.{j}")
            a.update(q=q, k=k, v=v, q3=q3, k3=k3, v3=v3, ps=[], o_blocks=[])
            o_blocks = []
            for b in range(QB):
                qblk = t.op(g, "slice_rows_3d", (q3,), (hg, qb, dh),
                            start=b * qb, stop=(b + 1) * qb,
                            name=f"L{l}.qb{g}.{j}.{b}")
                sc = t.op(g, "scores", (qblk, k3), (hg, qb, S),
                          flops=2 * hg * qb * S * dh,
                          scale=1.0 / math.sqrt(dh), causal=True,
                          q_offset=b * qb, name=f"L{l}.s{g}.{j}.{b}")
                p = t.op(g, "softmax", (sc,), (hg, qb, S),
                         flops=5 * hg * qb * S, name=f"L{l}.p{g}.{j}.{b}")
                ob = t.op(g, "attn_out", (p, v3), (hg, qb, dh),
                          flops=2 * hg * qb * S * dh,
                          name=f"L{l}.o{g}.{j}.{b}")
                a["ps"].append((qblk, sc, p, ob))
                o_blocks.append(ob)
            o3 = (o_blocks[0] if QB == 1 else
                  t.op(g, "concat", o_blocks, (hg, S, dh), axis=1,
                       name=f"L{l}.oc{g}.{j}"))
            om = t.op(g, "merge_heads", (o3,), (S, hgw),
                      name=f"L{l}.om{g}.{j}")
            a["o3"], a["om"] = o3, om
            part = t.op(g, "matmul", (om, wo), (S, d), flops=2 * S * hgw * d,
                        name=f"L{l}.ap{g}.{j}")
            att_parts.append(part)
    attn_out = t.reduce_parts(att_parts, 0, f"L{l}.attsum")
    h1 = t.op(0, "add", (x, attn_out), (S, d), name=f"L{l}.h1")
    sv["h1"] = h1

    n2_0 = t.op(0, "rmsnorm", (h1, weights["g2"]), (S, d),
                flops=5 * S * d, name=f"L{l}.n2")
    sv["n2"] = n2_0
    n2 = {g: t.bcast(n2_0, g) for g in range(G)}
    sv["n2_dev"] = n2
    Cs = tc.mlp_slices
    fcw = cfg.d_ff // (G * Cs)
    mlp_parts = []
    sv["mlp"] = {}
    for g in range(G):
        for c in range(Cs):
            wi = weights[f"wi{g}.{c}"]
            wo2 = weights[f"wo2{g}.{c}"]
            m = sv["mlp"][(g, c)] = {}
            u = t.op(g, "matmul", (n2[g], wi), (S, fcw),
                     flops=2 * S * d * fcw, name=f"L{l}.u{g}.{c}")
            if lora:
                Am = weights[f"Am{l}"]
                Bm = weights[f"Bm{g}.{c}"]
                t1 = t.op(g, "matmul_t", (n2[g], Am), (S, r),
                          flops=2 * S * d * r, name=f"L{l}.mlA{g}.{c}")
                t2 = t.op(g, "matmul_t", (t1, Bm), (S, fcw),
                          flops=2 * S * r * fcw, name=f"L{l}.mlB{g}.{c}")
                t2s = t.op(g, "scale", (t2,), (S, fcw), alpha=s_lora,
                           name=f"L{l}.mls{g}.{c}")
                u = t.op(g, "add", (u, t2s), (S, fcw), name=f"L{l}.u+{g}.{c}")
                m["t1"] = t1
            act = t.op(g, "gelu", (u,), (S, fcw), flops=8 * S * fcw,
                       name=f"L{l}.a{g}.{c}")
            part = t.op(g, "matmul", (act, wo2), (S, d),
                        flops=2 * S * fcw * d, name=f"L{l}.mp{g}.{c}")
            m.update(u=u, act=act)
            mlp_parts.append(part)
    mlp_out = t.reduce_parts(mlp_parts, 0, f"L{l}.mlpsum")
    out = t.op(0, "add", (h1, mlp_out), (S, d), name=f"L{l}.out")
    return out


def _make_layer_weights(t: _Tracer, l: int, *, lora: bool) -> dict:
    cfg, tc = t.cfg, t.tc
    G = tc.n_devices
    d, H, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    hg = min(tc.head_group, H // G) or 1
    J = (H // G) // hg
    hgw = hg * dh
    Cs = tc.mlp_slices
    fcw = cfg.d_ff // (G * Cs)
    r = tc.lora_rank
    ws: dict[str, int] = {
        "g1": t.w(0, (d,), f"L{l}.g1"),
        "g2": t.w(0, (d,), f"L{l}.g2"),
    }
    if lora:
        for nm in ("q", "k", "v"):
            ws[f"A{nm}{l}"] = t.w(0, (r, d), f"L{l}.A{nm}")
        ws[f"Am{l}"] = t.w(0, (r, d), f"L{l}.Am")
    for g in range(G):
        for j in range(J):
            for nm in ("wq", "wk", "wv"):
                ws[f"{nm}{g}.{j}"] = t.w(g, (d, hgw), f"L{l}.{nm}{g}.{j}")
            ws[f"wo{g}.{j}"] = t.w(g, (hgw, d), f"L{l}.wo{g}.{j}")
            if lora:
                for nm in ("q", "k", "v"):
                    ws[f"B{nm}{g}.{j}"] = t.w(g, (hgw, r),
                                              f"L{l}.B{nm}{g}.{j}")
        for c in range(Cs):
            ws[f"wi{g}.{c}"] = t.w(g, (d, fcw), f"L{l}.wi{g}.{c}")
            ws[f"wo2{g}.{c}"] = t.w(g, (fcw, d), f"L{l}.wo2{g}.{c}")
            if lora:
                ws[f"Bm{g}.{c}"] = t.w(g, (fcw, r), f"L{l}.Bm{g}.{c}")
    return ws


def trace_prefill(cfg: ArchConfig, *, seq_len: int, n_layers: int | None = None,
                  trace: TraceConfig = TraceConfig()) -> Traced:
    """First-token inference TASKGRAPH (paper §8 task 1, B=1)."""
    t = _Tracer(cfg, trace)
    t.meta_S = seq_len
    x = t.tg.add_input(0, TensorSpec((seq_len, cfg.d_model), trace.dtype),
                       name="x")
    h = x
    L = n_layers if n_layers is not None else cfg.n_layers
    for l in range(L):
        ws = _make_layer_weights(t, l, lora=False)
        h = _layer_forward(t, h, l, ws, lora=False)
    gf = t.w(0, (cfg.d_model,), "gf")
    hn = t.op(0, "rmsnorm", (h, gf), (seq_len, cfg.d_model), name="final_norm")
    last = t.op(0, "slice_rows", (hn,), (1, cfg.d_model), start=seq_len - 1,
                stop=seq_len, name="last_tok")
    wu = t.w(0, (cfg.d_model, cfg.vocab_size), "unembed")
    logits = t.op(0, "matmul", (last, wu), (1, cfg.vocab_size),
                  flops=2 * cfg.d_model * cfg.vocab_size, name="logits")
    return Traced(t.tg, t.weights, x, {}, {
        "kind": "prefill", "seq_len": seq_len, "n_layers": L,
        "logits": logits})


def trace_lora_train(cfg: ArchConfig, *, seq_len: int,
                     n_layers: int | None = None,
                     trace: TraceConfig = TraceConfig()) -> Traced:
    """LoRA fwd+bwd TASKGRAPH (paper §8 task 2). Activation checkpointing:
    only per-layer inputs are kept; layer internals are re-traced in the
    backward section. Gradients for every adapter are graph outputs."""
    t = _Tracer(cfg, trace)
    S = t.meta_S = seq_len
    d = cfg.d_model
    tc = trace
    G = tc.n_devices
    tg = t.tg
    x0 = tg.add_input(0, TensorSpec((S, d), tc.dtype), name="x")
    L = n_layers if n_layers is not None else cfg.n_layers

    layer_ws: list[dict] = []
    layer_in: list[int] = [x0]
    h = x0
    for l in range(L):
        ws = _make_layer_weights(t, l, lora=True)
        layer_ws.append(ws)
        h = _layer_forward(t, h, l, ws, lora=True)
        layer_in.append(h)

    # loss = sum(h_L)  →  dh_L = ones
    dh = tg.add_input(0, TensorSpec((S, d), tc.dtype), name="dloss",
                      op="input", params={"fill": "ones"})
    grads: dict[str, int] = {}

    H, dh_dim = cfg.n_heads, cfg.d_head
    hg = min(tc.head_group, H // G) or 1
    J = (H // G) // hg
    hgw = hg * dh_dim
    Cs = tc.mlp_slices
    fcw = cfg.d_ff // (G * Cs)
    r = tc.lora_rank
    s_lora = tc.lora_alpha / r
    QB = max(1, S // tc.q_block)
    qb = S // QB

    for l in reversed(range(L)):
        ws = layer_ws[l]
        x_l = layer_in[l]
        sv: dict = {}
        _ = _layer_forward(t, x_l, l, ws, lora=True, saved=sv)  # recompute

        # ---- MLP backward ----
        dn2_parts = []
        for g in range(G):
            dout_g = t.bcast(dh, g)
            for c in range(Cs):
                m = sv["mlp"][(g, c)]
                da = t.op(g, "matmul_t", (dout_g, ws[f"wo2{g}.{c}"]),
                          (S, fcw), flops=2 * S * d * fcw,
                          name=f"L{l}.bda{g}.{c}")
                du = t.op(g, "gelu_bwd", (m["u"], da), (S, fcw),
                          flops=10 * S * fcw, name=f"L{l}.bdu{g}.{c}")
                dn2_parts.append(t.op(
                    g, "matmul_t", (du, ws[f"wi{g}.{c}"]), (S, d),
                    flops=2 * S * d * fcw, name=f"L{l}.bdn2{g}.{c}"))
                # LoRA grads (chain through the scale)
                dus = t.op(g, "scale", (du,), (S, fcw), alpha=s_lora,
                           name=f"L{l}.bdus{g}.{c}")
                dBm = t.op(g, "matmul_tn", (dus, m["t1"]), (fcw, r),
                           flops=2 * S * fcw * r, name=f"L{l}.gBm{g}.{c}")
                grads[f"Bm{l}.{g}.{c}"] = dBm
                dt1 = t.op(g, "matmul", (dus, ws[f"Bm{g}.{c}"]), (S, r),
                           flops=2 * S * fcw * r, name=f"L{l}.bdt1m{g}.{c}")
                dn2_parts.append(t.op(
                    g, "matmul", (dt1, ws[f"Am{l}"]), (S, d),
                    flops=2 * S * r * d, name=f"L{l}.bdn2l{g}.{c}"))
                gAm = t.op(g, "matmul_tn", (dt1, sv["n2_dev"][g]), (r, d),
                           flops=2 * S * r * d, name=f"L{l}.gAmp{g}.{c}")
                grads.setdefault(f"Am{l}__parts", [])
                grads[f"Am{l}__parts"].append(gAm)
        dn2 = t.reduce_parts(dn2_parts, 0, f"L{l}.bdn2sum")
        grads[f"Am{l}"] = t.reduce_parts(grads.pop(f"Am{l}__parts"), 0,
                                         f"L{l}.gAmsum")
        dn2b = t.op(0, "rmsnorm_bwd", (sv["h1"], ws["g2"], dn2), (S, d),
                    flops=10 * S * d, name=f"L{l}.bn2")
        dh1 = t.op(0, "add", (dh, dn2b), (S, d), name=f"L{l}.bdh1")

        # ---- attention backward ----
        dn1_parts = []
        dAq_parts: dict[str, list[int]] = {"q": [], "k": [], "v": []}
        for g in range(G):
            dh1_g = t.bcast(dh1, g)
            for j in range(J):
                a = sv["attn"][(g, j)]
                dom = t.op(g, "matmul_t", (dh1_g, ws[f"wo{g}.{j}"]), (S, hgw),
                           flops=2 * S * d * hgw, name=f"L{l}.bdo{g}.{j}")
                do3 = t.op(g, "split_heads", (dom,), (hg, S, dh_dim),
                           n_heads=hg, name=f"L{l}.bdo3{g}.{j}")
                dq_blocks = []
                dk_parts, dv_parts = [], []
                for b, (qblk, sc, p, ob) in enumerate(a["ps"]):
                    dob = t.op(g, "slice_rows_3d", (do3,), (hg, qb, dh_dim),
                               start=b * qb, stop=(b + 1) * qb,
                               name=f"L{l}.bdob{g}.{j}.{b}")
                    dp = t.op(g, "matmul_t", (dob, a["v3"]), (hg, qb, S),
                              flops=2 * hg * qb * S * dh_dim,
                              name=f"L{l}.bdp{g}.{j}.{b}")
                    ds = t.op(g, "softmax_bwd", (p, dp), (hg, qb, S),
                              flops=6 * hg * qb * S,
                              name=f"L{l}.bds{g}.{j}.{b}")
                    dss = t.op(g, "scale", (ds,), (hg, qb, S),
                               alpha=1.0 / math.sqrt(dh_dim),
                               name=f"L{l}.bdss{g}.{j}.{b}")
                    dq_blocks.append(t.op(
                        g, "matmul", (dss, a["k3"]), (hg, qb, dh_dim),
                        flops=2 * hg * qb * S * dh_dim,
                        name=f"L{l}.bdq{g}.{j}.{b}"))
                    dk_parts.append(t.op(
                        g, "matmul_tn", (dss, qblk), (hg, S, dh_dim),
                        flops=2 * hg * qb * S * dh_dim,
                        name=f"L{l}.bdk{g}.{j}.{b}"))
                    dv_parts.append(t.op(
                        g, "matmul_tn", (p, dob), (hg, S, dh_dim),
                        flops=2 * hg * qb * S * dh_dim,
                        name=f"L{l}.bdv{g}.{j}.{b}"))
                dq3 = (dq_blocks[0] if QB == 1 else
                       t.op(g, "concat", dq_blocks, (hg, S, dh_dim), axis=1,
                            name=f"L{l}.bdqc{g}.{j}"))
                dk3 = t.reduce_parts(dk_parts, g, f"L{l}.bdksum{g}.{j}")
                dv3 = t.reduce_parts(dv_parts, g, f"L{l}.bdvsum{g}.{j}")
                for nm, d3 in (("q", dq3), ("k", dk3), ("v", dv3)):
                    dm = t.op(g, "merge_heads", (d3,), (S, hgw),
                              name=f"L{l}.bdm{nm}{g}.{j}")
                    dn1_parts.append(t.op(
                        g, "matmul_t", (dm, ws[f"w{nm}{g}.{j}"]), (S, d),
                        flops=2 * S * d * hgw,
                        name=f"L{l}.bdn1{nm}{g}.{j}"))
                    dms = t.op(g, "scale", (dm,), (S, hgw), alpha=s_lora,
                               name=f"L{l}.bdms{nm}{g}.{j}")
                    grads[f"B{nm}{l}.{g}.{j}"] = t.op(
                        g, "matmul_tn", (dms, a[f"t1{nm}"]), (hgw, r),
                        flops=2 * S * hgw * r, name=f"L{l}.gB{nm}{g}.{j}")
                    dt1 = t.op(g, "matmul", (dms, ws[f"B{nm}{g}.{j}"]),
                               (S, r), flops=2 * S * hgw * r,
                               name=f"L{l}.bdt1{nm}{g}.{j}")
                    dn1_parts.append(t.op(
                        g, "matmul", (dt1, ws[f"A{nm}{l}"]), (S, d),
                        flops=2 * S * r * d, name=f"L{l}.bdn1l{nm}{g}.{j}"))
                    dAq_parts[nm].append(t.op(
                        g, "matmul_tn", (dt1, sv["n1_dev"][g]), (r, d),
                        flops=2 * S * r * d, name=f"L{l}.gA{nm}p{g}.{j}"))
        for nm in ("q", "k", "v"):
            grads[f"A{nm}{l}"] = t.reduce_parts(
                dAq_parts[nm], 0, f"L{l}.gA{nm}sum")
        dn1 = t.reduce_parts(dn1_parts, 0, f"L{l}.bdn1sum")
        dn1b = t.op(0, "rmsnorm_bwd", (x_l, ws["g1"], dn1), (S, d),
                    flops=10 * S * d, name=f"L{l}.bn1")
        dh = t.op(0, "add", (dh1, dn1b), (S, d), name=f"L{l}.bdx")

    return Traced(t.tg, t.weights, x0, grads, {
        "kind": "lora_train", "seq_len": S, "n_layers": L})
