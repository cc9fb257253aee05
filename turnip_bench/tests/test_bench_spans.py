"""The program's spans in a trace (``spans.py``) on made-up events: each
label, the four readers of the spans, the breakdowns, and the existing
metrics unchanged by the reading; and the link from a backward node to
the forward's span on a CPU profile of the program."""
from __future__ import annotations

import pytest

from turnip_bench import harness, spans, trace
from turnip_bench.costs import wkv6_fwd
from turnip_bench.spans import Device, Host, Row, Span

from conftest import tiny_cell

EXISTING = ("data_ms.train", "gemm_ms.train", "mfu.train",
            "copy_exposed_ms.train", "peak_hbm_gib.train",
            "offload_gib.train", "wkv6_bwd_roofline.train",
            "idle_share.train")


def _events():
    """Thread 1 runs the forward, thread 2 the backward: a mix, a wkv6
    call, a node whose forward operator was in the mix, the engine's own
    sum, a layer's replay, the backward kernel's span, and launches
    outside every span."""
    host = [
        Host("span", "turnip.step.forward", 0, 10, 1),
        Host("span", "turnip.layer", 1, 4, 1),
        Host("span", "turnip.rwkv.mix", 1.5, 2, 1),
        Host("op", "aten::mul", 1.6, 1.65, 1, 5),
        Host("op", "aten::add", 1.7, 1.75, 1, 6),
        Host("span", "turnip.kernel.wkv6", 2.5, 3, 1),
        Host("op", "WKV6Fn", 2.6, 2.9, 1, 7),
        Host("span", "turnip.step.backward", 10, 30, 1),
        Host("node", "autograd::engine::evaluate_function: MulBackward0",
             11, 12.9, 2, 1, 5),
        Host("body", "MulBackward0", 11.1, 11.8, 2),
        Host("node", "autograd::engine::evaluate_function: AddBackward0",
             13, 18, 2, 1, 6),
        Host("body", "AddBackward0", 13.1, 17.9, 2),
        Host("span", "turnip.layer", 13.2, 17, 2),
        Host("span", "turnip.rwkv.mix", 13.3, 13.5, 2),
        Host("node", "autograd::engine::evaluate_function: WKV6FnBackward",
             19, 21, 2, 1, 7),
        Host("body", "WKV6FnBackward", 19.1, 20.9, 2),
        Host("span", "turnip.kernel.wkv6_bwd", 19.2, 20.8, 2),
    ]
    launches = {1: (1.6, 1), 2: (2.6, 1), 3: (2.61, 1), 4: (2.62, 1),
                5: (11.5, 2), 6: (12.5, 2), 7: (13.4, 2), 8: (19.5, 2),
                9: (25, 2), 10: (35, 1)}
    host += [Host("launch", "cudaLaunchKernel", t, t, th, c)
             for c, (t, th) in launches.items()]
    device = [Device(f"k{c}", 40 + c, 40.5 + c, 7, c) for c in launches]
    device += [Device("k_lost", 60, 61, 7, 99)]
    return host, device


def test_each_launch_is_put_down_to_its_span():
    reading = spans.attribute(*_events())
    labels = {r.name: r.label for r in reading.rows}
    assert labels == {
        "k1": "turnip.rwkv.mix", "k2": "turnip.kernel.wkv6",
        "k3": "turnip.kernel.wkv6", "k4": "turnip.kernel.wkv6",
        "k5": "turnip.rwkv.mix:backward",     # by the node's sequence nr
        "k6": spans.AUTOGRAD,                  # the engine's own sum
        "k7": "turnip.rwkv.mix:recompute",
        "k8": "turnip.kernel.wkv6_bwd:backward",
        "k9": spans.AUTOGRAD,                  # between nodes
        "k10": spans.NO_SPAN, "k_lost": spans.NO_SPAN}
    by_name = {r.name: r for r in reading.rows}
    # the three kernels of one call share its span
    assert len({by_name[k].span for k in ("k2", "k3", "k4")}) == 1
    assert reading.spans[by_name["k5"].span].start == 1.5
    assert by_name["k_lost"].thread == -1


def _run(reading, tl=None, **kw):
    tl = tl or trace.Timeline([], [], [], 100.0)
    tl.program = reading
    return harness.Run(cell=tiny_cell(), window_s=tl.window_s,
                       units=kw.pop("units", 2),
                       lengths=kw.pop("lengths", [[64, 64], [64, 64]]),
                       timeline=tl, **kw)


def test_span_readers():
    reading = spans.attribute(*_events())
    run = _run(reading)
    # k1, k5 and k7, 0.5 s each, over two steps
    assert harness.metric_module("mix_ms.train").read(run) == \
        pytest.approx(1e3 * 1.5 / 2)
    # no merge span: nothing to read
    assert harness.metric_module("lora_merge_ms.train").read(run) is None
    for name in ("mix_ms.train", "lora_merge_ms.train",
                 "reload_wait_ms.train", "wkv6_roofline.train"):
        m = harness.metric_module(name)
        assert m.read(_run(spans.Reading([], []))) is None
        assert m.read(harness.Run(cell=tiny_cell(), window_s=1.0, units=1,
                                  lengths=[[64]],
                                  timeline=trace.Timeline([], [], [], 1.0))
                      ) is None


def test_wkv6_roofline_finds_whole_calls_by_their_span():
    reading = spans.attribute(*_events())
    m = harness.metric_module("wkv6_roofline.train")
    run = _run(reading, lengths=[[64, 64]], counters={"wkv6": 1})
    a = run.cell.arch
    P = a["rwkv_headdim"]
    bound, binds = wkv6_fwd.wkv6_bound_s(2, 64, a["d_model"] // P, P, 32, 4)
    assert m.read(run) == pytest.approx(100 * bound / 1.5)
    run.counters["wkv6"] = 2               # the trace lost a call
    assert m.read(run) is None
    # a call with a kernel dropped is not found
    host, device = _events()
    device = [d for d in device if d.name != "k3"]
    run = _run(spans.attribute(host, device), counters={"wkv6": 1})
    assert m.read(run) is None


def _offload_reading():
    sp = [Span("turnip.step.backward", 10, 30, 1),
          Span("turnip.offload.reload", 11, 11.1, 2),
          Span("turnip.offload.wait", 12, 12.01, 2),
          Span("turnip.offload.reload", 12.02, 12.1, 2),
          Span("turnip.offload.wait", 15, 15.01, 2)]
    rows = [Row("k_a", 11.6, 12.5, 7, "x", -1, 11.5, 2),
            Row("Memcpy HtoD (Pinned -> Device)", 11.2, 13.0, 20,
                "turnip.offload.reload:backward", 1, 11.05, 2),
            Row("k_b", 13.05, 14.0, 7, "x", -1, 12.05, 2),
            Row("Memcpy HtoD (Pinned -> Device)", 12.2, 13.5, 20,
                "turnip.offload.reload:backward", 3, 12.05, 2),
            Row("k_c", 14.6, 15.2, 7, "x", -1, 14.5, 2),
            Row("k_d", 15.3, 16.0, 7, "x", -1, 15.1, 2)]
    return spans.Reading(sp, sorted(rows, key=lambda r: r.start))


def test_reload_wait_counts_the_waits_a_reload_holds_up(capsys):
    m = harness.metric_module("reload_wait_ms.train")
    reading = _offload_reading()
    # the first wait: k_a ends at 12.5, its reload's copy at 13.0, k_b
    # starts at 13.05; the second reload's copy ended before k_c did
    assert m.waits(reading) == [(1, pytest.approx(0.55))]
    assert m.read(_run(reading, units=1)) == pytest.approx(550.0)
    assert "layers 1: " in capsys.readouterr().err


def test_existing_metrics_read_the_same_with_the_spans():
    k = [("void wkv6_states<float>(Params)", 0.0, 0.5, 7),
         ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", 1.0, 3.0, 7)]
    c = [("Memcpy DtoH (Device -> Pinned)", 2.0, 4.0, 13)]
    host = [("aten::mm", 0.9, 3.1)]
    cell = tiny_cell()

    def read_all(tl):
        run = harness.Run(cell=cell, window_s=5.0, units=2,
                          lengths=[[64, 64]] * 2, timeline=tl,
                          spans={"feed": [0.001]},
                          counters={"offloaded_bytes": 2**30,
                                    "wkv6_bwd": 0},
                          peak_bytes=2**30)
        return ({m: harness.metric_module(m).read(run) for m in EXISTING},
                trace.device_ops(tl), trace.idle_gaps(tl))

    plain = read_all(trace.Timeline(list(k), list(c), list(host), 5.0))
    tl = trace.Timeline(list(k), list(c), list(host), 5.0)
    tl.program = spans.attribute(*_events())
    assert read_all(tl) == plain


def test_breakdowns_and_install():
    spans.install()
    spans.install()
    assert trace.from_profiler.reads_spans
    k = [("k", 0.0, 1.0, 7), ("k", 2.0, 3.0, 7)]
    tl = trace.Timeline(k, [], [("aten::mm", 0.5, 2.5)], 4.0)
    reading = spans.Reading(
        [Span("turnip.step.forward", 0.0, 4.0, 1),
         Span("turnip.layer", 1.2, 1.8, 1)],
        [Row("k", 0.0, 1.0, 7, "turnip.layer", 1, 0.0, 1),
         Row("k", 2.0, 3.0, 7, spans.NO_SPAN, -1, 1.9, 1),
         Row("k", 3.0, 3.5, 7, "turnip.layer", 1, 2.0, 1)])
    assert spans.device_spans(reading) == [["turnip.layer", 1.5],
                                           [spans.NO_SPAN, 1.0]]
    # gaps [1, 2] and [3, 4]: the layer is open at 1.5, the step at 3.5
    assert spans.idle_spans(tl, reading) == [
        ["turnip.layer", pytest.approx(1.0)],
        ["turnip.step.forward", pytest.approx(1.0)]]
    run = _run(reading, tl)
    metrics, breakdown = harness.traced_metrics(run)
    assert breakdown["device_ops"] == trace.device_ops(tl)
    assert breakdown["idle_gaps"] == trace.idle_gaps(tl)
    assert breakdown["device_spans"] == spans.device_spans(reading)
    assert breakdown["idle_spans"] == spans.idle_spans(tl, reading)
    tl.program = spans.Reading([], [])
    assert set(harness.traced_metrics(run)[1]) == {"device_ops",
                                                   "idle_gaps"}


def test_backward_nodes_lead_to_the_forward_mixes_on_a_cpu_profile():
    """The program's own spans in a CPU profile of a tiny LoRA step, each
    operator of a MulBackward0 or AddBackward0 node standing in for a
    launch: they are put down to the mixes' spans."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import build_model
    from repro_torch.models.lora import lora_init, make_lora_loss
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import make_train_step
    import dataclasses
    cfg = dataclasses.replace(reduced(get_arch("rwkv6-7b")),
                              dtype="float32")
    model = build_model(cfg, remat="offload", device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    ad = lora_init(gen, params, rank=4)
    opt = AdamW()
    step = make_train_step(model, opt,
                           loss_fn=make_lora_loss(model, params, rank=4))
    state = {"params": ad, "opt": opt.init(ad),
             "step": torch.zeros((), dtype=torch.int32)}
    tok = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            step(state, {"tokens": tok, "labels": tok})
    host, _ = spans.extract(prof)
    bodies = [h for h in host if h.kind == "body"
              and h.name in ("MulBackward0", "AddBackward0")]
    fake, extra = [], []
    for i, b in enumerate(bodies):
        t = (b.start + b.end) / 2
        extra.append(Host("launch", "cudaLaunchKernel", t, t, b.thread,
                          10**9 + i))
        fake.append(Device(b.name, t, t + 1e-6, 7, 10**9 + i))
    reading = spans.attribute(host + extra, fake)
    got = {(r.name, r.label) for r in reading.rows}
    assert ("MulBackward0", "turnip.rwkv.mix:backward") in got
    assert ("AddBackward0", "turnip.rwkv.mix:backward") in got
    names = {s.name for s in reading.spans}
    assert {"turnip.layer", "turnip.rwkv.mix", "turnip.lora.merge",
            "turnip.offload.pack", "turnip.offload.reload"} <= names


@pytest.mark.parametrize("shape", [(2, 8192, 64, 64, 32),
                                   (1, 100, 4, 16, 32), (3, 33, 2, 64, 16)])
def test_wkv6_fwd_cost_equals_the_programs(shape):
    from repro_torch.kernels.rwkv6 import ops
    assert wkv6_fwd.wkv6_cost(*shape, 4) == ops.wkv6_cost(*shape, 4)
    assert sum(wkv6_fwd.wkv6_ops_split(*shape)) == ops.wkv6_ops(*shape)


def test_wkv6_fwd_bound_at_the_main_path_shape():
    # at 2 x 8192, 64 heads of 64, chunk 32: 21.34 GFLOP of products and
    # 2.68 of the rest (0.1693 ms at 165 and 67 TFLOP/s) against 1.34 GB
    # read and written (0.4006 ms at 3.35 TB/s): bound by the bytes
    assert wkv6_fwd.wkv6_ops_split(2, 8192, 64, 64, 32) == \
        (21340618752, 2684354560)
    bound, binds = wkv6_fwd.wkv6_bound_s(2, 8192, 64, 64, 32, 4)
    assert bound * 1e3 == pytest.approx(0.4006, abs=5e-5)
    assert binds == "bytes"


def test_exposed_copies_by_span():
    m = harness.metric_module("reload_wait_ms.train")
    # kernels cover [11.6, 12.5], [13.05, 14], [14.6, 15.2], [15.3, 16]:
    # the first copy [11.2, 13.0] is exposed 0.4 + 0.5, the second
    # [12.2, 13.5] from 12.5 to 13.05
    got = m.exposed_copies(_offload_reading())
    assert got == {"turnip.offload.reload:backward": pytest.approx(
        0.9 + (13.05 - 12.5))}
