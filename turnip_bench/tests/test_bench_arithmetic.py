"""The harness's arithmetic on made-up profiles: interval unions, the
rates, the attribution of kernels to an operator's calls and the
per-layer metrics read from a made-up window."""
from __future__ import annotations

import math

import pytest

from turnip_bench import harness, trace

from conftest import tiny_cell


def test_union_and_subtract():
    assert trace.union([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
    assert trace.union_length([(0, 1), (0.5, 2), (3, 4)]) == 3
    assert trace.subtract_length([(0, 10)], [(1, 2), (4, 6), (9, 12)]) == 6
    assert trace.subtract_length([(0, 1), (2, 3)], [(0.5, 2.5)]) == 1
    assert trace.subtract_length([(0, 1)], []) == 1


def test_base_name_and_calls():
    assert trace.base_name("void ssd_pass<4, true>(Params)") == "ssd_pass"
    assert trace.base_name("wkv6_bwd_du(BwdParams)") == "wkv6_bwd_du"
    assert trace.base_name(
        "void (anonymous namespace)::ssd_out<float>((anonymous namespace)"
        "::Params)") == "ssd_out"
    rows = [("void a<1>(P)", 0, 1, 7), ("b(P)", 1, 2, 7), ("x", 2, 3, 7),
            ("void a<2>(P)", 3, 4, 7), ("b", 4, 6, 7), ("a", 0, 1, 9),
            ("b", 2, 3, 9)]
    calls = trace.match_calls(rows, ["a", "b"])
    assert sorted([r[1] for r in c] for c in calls) == \
        [[0, 1], [0, 2], [3, 4]]


WKV_BWD = ["void wkv6_states<float>(Params)", "wkv6_carry(Params)",
           "void (anonymous namespace)::wkv6_bwd_gstates<float>("
           "(anonymous namespace)::BwdParams)", "wkv6_bwd_carry(BwdParams)",
           "void wkv6_bwd_chunk<float, 4>(BwdParams)",
           "wkv6_bwd_du(BwdParams)"]


def _timeline():
    k = [(name, 0.75 * j, 0.75 * (j + 1), 7)
         for j, name in enumerate(WKV_BWD[:-1])]
    k += [(WKV_BWD[-1], 3.75, 4.5, 7),
          ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", 5.0, 7.0, 7),
          ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 7.0, 8.0, 7)]
    c = [("Memcpy DtoH (Device -> Pinned)", 6.0, 9.0, 13),
         ("Memcpy HtoD (Pinned -> Device)", 9.5, 9.75, 14),
         ("Memset (Device)", 9.75, 9.8, 7)]
    host = [("turnip_bench.window", 0.0, 10.0), ("aten::mm", 8.9, 9.6),
            ("cudaHostAlloc", 9.8, 10.0)]
    return trace.Timeline(k, c, host, 10.0)


def _run(tl, **kw):
    cell = tiny_cell()
    return harness.Run(cell=cell, window_s=tl.window_s, units=2,
                       lengths=kw.pop("lengths", [[64, 64], [64, 64]]),
                       timeline=tl, **kw)


def test_device_metrics_on_a_made_up_window():
    tl = _timeline()
    run = _run(tl, spans={"feed": [0.001, 0.003]},
               counters={"offloaded_bytes": 2 * 2**30}, peak_bytes=3 * 2**30)
    read = {m: harness.metric_module(m).read(run) for m in (
        "idle_share.train", "copy_exposed_ms.train", "gemm_ms.train",
        "data_ms.train", "offload_gib.train", "peak_hbm_gib.train")}
    # busy: [0, 4.5], [5, 9] and [9.5, 9.8]
    assert read["idle_share.train"] == pytest.approx(100 * (1 - 8.8 / 10))
    # copies outside kernels: [8, 9] and [9.5, 9.75], over 2 steps
    assert read["copy_exposed_ms.train"] == pytest.approx(1e3 * 1.25 / 2)
    assert read["gemm_ms.train"] == pytest.approx(1e3 * 3 / 2)
    assert read["data_ms.train"] == pytest.approx(2.0)
    assert read["offload_gib.train"] == pytest.approx(1.0)
    assert read["peak_hbm_gib.train"] == pytest.approx(3.0)
    # gaps [4.5, 5], [9, 9.5], [9.8, 10]
    assert trace.idle_gaps(tl) == [
        ["turnip_bench.window", pytest.approx(0.5)],
        ["aten::mm", pytest.approx(0.5)],
        ["cudaHostAlloc", pytest.approx(0.2)]]
    ops = trace.device_ops(tl)
    assert ops[0] == ["Memcpy DtoH (Device -> Pinned)", 3.0]


def test_roofline_share_checks_the_launch_counter():
    from turnip_bench.costs import wkv6
    tl = _timeline()
    m = harness.metric_module("wkv6_bwd_roofline.train")
    run = _run(tl, lengths=[[64, 64]], counters={"wkv6_bwd": 1})
    a = run.cell.arch
    P = a["rwkv_headdim"]
    want = 100 * wkv6.wkv6_bwd_bound_s(2, 64, a["d_model"] // P, P, 32,
                                       4) / 4.5
    assert m.read(run) == pytest.approx(want)
    run.counters["wkv6_bwd"] = 2              # the trace lost a call
    assert m.read(run) is None


def test_program_counters_are_read_where_the_metrics_name_them(
        monkeypatch):
    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.models import offload
    cell = tiny_cell()
    monkeypatch.setattr(ops.wkv6_bwd, "launches", 7, raising=False)
    monkeypatch.setitem(offload.moved, "offloaded", 123)
    assert harness.program_counters(cell) == {"wkv6_bwd": 7,
                                              "offloaded_bytes": 123}


def test_rates_and_mfu():
    from turnip_bench.costs import model_flops, peaks
    tl = trace.Timeline([], [], [], 4.0)
    run = _run(tl)
    want = 100 * 4 * model_flops.lora_step_flops(run.cell.config, 64, 16) \
        / 4.0 / peaks.BF16_FLOPS
    assert harness.metric_module("mfu.train").read(run) == pytest.approx(want)
    assert harness.metric_module("idle_share.train").read(run) is None


def test_checks_block():
    ok, block = harness.checks_block({"a": 0.1, "b": math.nan},
                                     {"a": 0.2, "b": 1.0})
    assert not ok and block["a"] == {"value": 0.1, "limit": 0.2}
    assert block["b"] == {"value": None, "limit": 1.0}
    ok, _ = harness.checks_block({"a": 0.1}, {"a": 0.2})
    assert ok
