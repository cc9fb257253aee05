"""The port's profiler spans (``repro_torch.spans``): the no-op path with
no profiler on, the names, how often a LoRA step opens each, and the
backward's link to the forward's spans by sequence number. CPU tests; the
one test marked ``cuda`` runs on the card (it imports no JAX):

    python -m pytest -q -m cuda tests/test_torch_spans.py
"""
from __future__ import annotations

import dataclasses
import pathlib
import re

import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get_arch, reduced
from repro_torch.models import build_model
from repro_torch.models.lora import lora_init, make_lora_loss
from repro_torch.train.optim import AdamW
from repro_torch.train.step import make_train_step

SRC = pathlib.Path(spans.__file__).resolve().parent
NODE = "autograd::engine::evaluate_function: "
# the hand-written kernels of an rwkv step, by base name, and the spans
# of the ops that launch them (the scan's backward reruns two of the
# forward's passes)
KERNELS = {"rmsnorm_rows": ("rmsnorm",),
           "rmsnorm_bwd_rows": ("rmsnorm_bwd",),
           "rmsnorm_dg_reduce": ("rmsnorm_bwd",),
           "wkv6_states": ("wkv6", "wkv6_bwd"),
           "wkv6_carry": ("wkv6", "wkv6_bwd"), "wkv6_out": ("wkv6",),
           "wkv6_bwd_gstates": ("wkv6_bwd",), "wkv6_bwd_carry": ("wkv6_bwd",),
           "wkv6_bwd_chunk": ("wkv6_bwd",), "wkv6_bwd_du": ("wkv6_bwd",)}


def _lora_step(device: str, *, n_layers: int = 2, S: int = 16,
               dtype: str = "float32"):
    """(a LoRA step of a tiny rwkv model with ``remat='offload'``, its
    state, a batch, the config); the adapters on wk and wv."""
    cfg = dataclasses.replace(reduced(get_arch("rwkv6-7b")), dtype=dtype,
                              n_layers=n_layers)
    model = build_model(cfg, remat="offload", device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen)
    ad = lora_init(gen, params, rank=4)
    for ab in ad.values():                 # B nonzero: every path live
        ab["B"].normal_(generator=gen)
    opt = AdamW()
    step = make_train_step(model, opt,
                           loss_fn=make_lora_loss(model, params, rank=4))
    state = {"params": ad, "opt": opt.init(ad),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    tok = torch.randint(0, cfg.vocab_size, (2, S), generator=gen,
                        device=device)
    return step, state, {"tokens": tok, "labels": tok}, cfg


def _profiled_step(device: str, activities, **kw):
    step, state, batch, cfg = _lora_step(device, **kw)
    state, _ = step(state, batch)                      # warm up
    with torch.profiler.profile(activities=activities) as prof:
        step(state, batch)
    return prof.profiler.kineto_results.events(), cfg


def _innermost_span(events, thread: int, t_ns: int) -> str | None:
    """The innermost ``turnip.*`` span open on ``thread`` at ``t_ns``."""
    best = None
    for e in events:
        if (e.is_user_annotation() and e.name().startswith("turnip.")
                and e.device_type().name == "CPU"
                and e.start_thread_id() == thread
                and e.start_ns() <= t_ns <= e.end_ns()
                and (best is None or e.start_ns() > best.start_ns())):
            best = e
    return None if best is None else best.name()


def test_no_profiler_no_range(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: entered.append(name))
    a, b = spans.span("turnip.layer"), spans.span("turnip.lora.merge")
    assert a is b
    with a:
        pass
    assert spans.spanned("turnip.layer")(lambda x: x + 1)(1) == 2
    assert entered == []


def test_every_span_in_the_source_is_listed_once():
    assert len(set(spans.NAMES)) == len(spans.NAMES)
    used = set()
    for path in SRC.rglob("*.py"):
        used |= set(re.findall(r'span(?:ned)?\("([^"]+)"\)',
                               path.read_text()))
    assert used == set(spans.NAMES)
    assert all(re.fullmatch(r"turnip\.[a-z_.0-9]+", n) for n in spans.NAMES)


def test_spans_change_nothing_the_step_computes():
    cpu = [torch.profiler.ProfilerActivity.CPU]
    step, state, batch, _ = _lora_step("cpu")
    plain, m_plain = step(state, batch)
    with torch.profiler.profile(activities=cpu):
        traced, m_traced = step(state, batch)
    assert torch.equal(m_plain["loss"], m_traced["loss"])
    for p, ab in plain["params"].items():
        for k, t in ab.items():
            assert torch.equal(t, traced["params"][p][k]), (p, k)


def test_a_lora_step_opens_each_span_as_often_as_expected():
    events, cfg = _profiled_step("cpu", [torch.profiler.ProfilerActivity.CPU],
                                 n_layers=3)
    L, targets = cfg.n_layers, 2            # wk and wv
    counts = {}
    for e in events:
        if e.is_user_annotation() and e.name().startswith("turnip."):
            counts[e.name()] = counts.get(e.name(), 0) + 1
    # the forward and the checkpoint's recompute each run every layer;
    # on the CPU the scan is the plain version, differentiated by autograd
    # (no backward kernel, no stream to wait on)
    assert counts == {
        "turnip.step.forward": 1, "turnip.step.backward": 1,
        "turnip.step.optimizer": 1, "turnip.lm.head": 2,
        "turnip.layer": 2 * L, "turnip.rwkv.time_mix": 2 * L,
        "turnip.rwkv.channel_mix": 2 * L, "turnip.rwkv.mix": 2 * 2 * L,
        "turnip.rwkv.wkv": 2 * L, "turnip.kernel.wkv6": 2 * L,
        "turnip.lora.merge": 2 * targets * L,
        "turnip.offload.pack": L, "turnip.offload.reload": L}


def test_backward_nodes_lead_to_the_forward_spans():
    events, _ = _profiled_step("cpu", [torch.profiler.ProfilerActivity.CPU])
    # a forward operator under grad, by (thread, sequence number): the
    # last to start took the node
    forward = {}
    for e in events:
        if (e.device_type().name == "CPU" and not e.is_user_annotation()
                and e.sequence_nr() >= 0 and e.fwd_thread_id() == 0
                and not e.name().startswith(NODE) and e.scope() == 0):
            key = (e.start_thread_id(), e.sequence_nr())
            if key not in forward or forward[key].start_ns() < e.start_ns():
                forward[key] = e
    found = {}
    for e in events:
        name = e.name()
        if name in (NODE + "MulBackward0", NODE + "AddBackward0"):
            op = forward.get((e.fwd_thread_id(), e.sequence_nr()))
            assert op is not None, name
            where = _innermost_span(events, op.start_thread_id(),
                                    op.start_ns())
            found.setdefault(name, set()).add(where)
    assert "turnip.rwkv.mix" in found[NODE + "MulBackward0"]
    assert "turnip.rwkv.mix" in found[NODE + "AddBackward0"]


@pytest.mark.cuda
def test_each_hand_written_kernel_lies_under_its_span():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    events, _ = _profiled_step(
        "cuda", [torch.profiler.ProfilerActivity.CPU,
                 torch.profiler.ProfilerActivity.CUDA],
        n_layers=2, S=256, dtype="bfloat16")
    # a runtime call is linked to the operator it ran in; a kernel shares
    # the runtime call's correlation id
    launches = {e.correlation_id(): e for e in events
                if e.device_type().name == "CPU"
                and e.linked_correlation_id() > 0}
    seen = set()
    for e in events:
        if e.device_type().name != "CUDA" or e.is_user_annotation():
            continue
        base = re.sub(r"^void |\(anonymous namespace\)::", "",
                      e.name()).split("<")[0].split("(")[0].strip()
        if base not in KERNELS:
            continue
        launch = launches.get(e.correlation_id())
        assert launch is not None, base
        where = _innermost_span(events, launch.start_thread_id(),
                                launch.start_ns())
        assert where in [f"turnip.kernel.{op}" for op in KERNELS[base]], \
            (base, where)
        seen.add(base)
    assert {"rmsnorm_rows", "rmsnorm_bwd_rows", "wkv6_out",
            "wkv6_bwd_chunk"} <= seen, seen
