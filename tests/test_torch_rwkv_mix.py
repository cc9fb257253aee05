"""RWKV-6's fused token-shift mixes (``repro_torch/kernels/rwkv6/mix.py``).

CPU: the op's plain definition against the composition the model wrote
before it (token shift, ``xs - x``, the ``[B, S, K, D]`` mixes, one select
a mix); the backward's formulas (:func:`rwkv_mix_bwd_plain`, the kernel's
function) and :class:`MixFn` driven with plain stand-ins against autograd
through that composition, for the time and the channel mix, with no
carried shift and with one (needing a gradient or not), several sequences
(no shift across them), S = 1 and odd D; the static mixes' and
``lora_B``'s gradients; a shape-only call that records and launches
nothing; the wrapper's refusals; which op the model takes. The tests
marked ``cuda`` run on the card (the file imports no JAX):

    python -m pytest -q -m cuda tests/test_torch_rwkv_mix.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import re

import pytest
import torch

from repro_torch.kernels.rwkv6 import mix as M
from repro_torch.kernels.shape_only import recording

# (B, S, D, R): several sequences, one row each, odd D, the cell's R
SHAPES = [(3, 7, 12, 8), (2, 1, 9, 4), (1, 5, 16, 16)]
PREV = ["none", "carried", "carried_grad"]
KINDS = ["time", "channel"]


def composition(x, prev, mix, lr=None, lora_B=None):
    """models/rwkv.py's two mixes as they were written before the op."""
    xs = torch.cat([torch.zeros_like(x[:, :1]) if prev is None else prev,
                    x[:, :-1]], dim=1)
    dx = xs - x
    if lr is None:
        return tuple(x + dx * m for m in mix)
    mixes = mix[None, None] + torch.einsum("bsfr,frd->bsfd", lr, lora_B)
    return tuple(x + dx * mixes[:, :, i] for i in range(mix.shape[0]))


def _inputs(kind, B, S, D, R, prev, *, dtype=torch.float64, device="cpu",
            seed=0, grad_weights=False):
    """(x, prev, mix, lr, lora_B) with x, lr and (``carried_grad``) prev
    needing gradients; the weights too with ``grad_weights``."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(device, dtype)
    x = rnd(B, S, D).requires_grad_()
    p = None if prev == "none" else rnd(B, 1, D)
    if prev == "carried_grad":
        p.requires_grad_()
    K = 5 if kind == "time" else 2
    mix = torch.rand(K, D, generator=gen).to(device, dtype)
    lr = lb = None
    if kind == "time":
        lr = torch.tanh(rnd(B, S, K, R)).requires_grad_()
        lb = rnd(K, R, D, scale=0.1)
    if grad_weights:
        mix.requires_grad_()
        if lb is not None:
            lb.requires_grad_()
    if kind == "channel":
        mix = tuple(mix.unbind(0)) if not grad_weights else \
            tuple(m.detach().clone().requires_grad_() for m in mix.unbind(0))
    return x, p, mix, lr, lb


def _leaves(x, p, mix, lr, lb):
    mixes = list(mix) if isinstance(mix, tuple) else [mix]
    return [t for t in (x, p, lr, lb, *mixes)
            if t is not None and t.requires_grad]


def _cotangents(outs, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(o.shape, generator=gen, dtype=o.dtype) for o in outs]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("prev", PREV)
def test_plain_is_the_composition(kind, shape, prev):
    """On the CPU the op is its plain definition, and that is the
    composition, bit for bit."""
    args = _inputs(kind, *shape, prev, dtype=torch.float32)
    want = composition(*args)
    for got in (M.rwkv_mix_plain(*args), M.rwkv_mix(*args)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("prev", PREV)
def test_backward_formula_matches_autograd(kind, shape, prev):
    """:func:`rwkv_mix_bwd_plain` (the kernel's dx, dprev, dlr) against
    autograd through the composition, in float64 inputs (the formula sums
    in float32)."""
    x, p, mix, lr, lb = _inputs(kind, *shape, prev)
    if p is not None:
        p.requires_grad_()
    outs = composition(x, p, torch.stack(mix) if kind == "channel" else mix,
                       lr, lb)
    dys = _cotangents(outs)
    wrt = [t for t in (x, p, lr) if t is not None]
    want = torch.autograd.grad(outs, wrt, dys)
    dx, dprev, dlr = M.rwkv_mix_bwd(x.detach(), p, mix, lr, lb, dys)
    got = [dx] + ([dprev] if p is not None else []) \
        + ([dlr] if lr is not None else [])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    if p is None:
        assert dprev is None


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("grad_weights", [False, True])
def test_function_matches_autograd(kind, shape, grad_weights):
    """:class:`MixFn` with the plain stand-ins (the forward's definition,
    the backward's formulas): every input's gradient, the static mixes'
    and ``lora_B``'s included when they train, against autograd through
    the composition; an input that needs none gets none."""
    prev = "carried_grad" if grad_weights else "carried"
    args = _inputs(kind, *shape, prev, grad_weights=grad_weights)
    x, p, mix, lr, lb = args
    rows = list(mix) if kind == "channel" else list(mix.unbind(0))
    got = M.MixFn.apply(x, p, lr, lb,
                        lambda *a: M.rwkv_mix_plain(*a),
                        M.rwkv_mix_bwd_plain, *rows)
    want = composition(x, p, torch.stack(rows) if kind == "channel" else mix,
                       lr, lb)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    dys = _cotangents(want)
    leaves = _leaves(*args)
    g_got = torch.autograd.grad(got, leaves, dys)
    g_want = torch.autograd.grad(want, leaves, dys)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert len(leaves) == (2 if kind == "time" else 1) + 3 * grad_weights


@pytest.mark.parametrize("kind", KINDS)
def test_no_shift_across_sequences(kind):
    """The first row of each sequence mixes with its own carried shift (or
    zeros), never the previous sequence's last row; the backward's shift
    stops at each sequence's last row."""
    x, p, mix, lr, lb = _inputs(kind, 3, 4, 8, 8, "none",
                                dtype=torch.float32)
    x = x.detach()
    outs = M.rwkv_mix(x, None, mix, lr, lb)
    m0 = (mix[0] if kind == "channel"
          else mix[0] + lr[:, 0, 0].detach() @ lb[0])
    torch.testing.assert_close(outs[0][:, 0], x[:, 0] - x[:, 0] * m0)
    dys = [torch.zeros_like(x) for _ in outs]
    dys[0][1, 0] = 1.0                   # the second sequence's first row
    dx = M.rwkv_mix_bwd(x, None, mix, lr, lb, dys)[0]
    assert not dx[0].any() and not dx[2].any()   # nothing into its neighbours
    assert dx[1, 0].any()


@pytest.mark.parametrize("kind", KINDS)
def test_shape_only_records_and_launches_nothing(kind):
    """Meta tensors under grad: the forward and the backward each record
    their costs once, nothing launches, the shapes are the inputs'."""
    x, p, mix, lr, lb = _inputs(kind, 2, 8, 16, 16, "carried_grad",
                                dtype=torch.bfloat16, device="meta")
    before = (M.rwkv_mix.launches, M.rwkv_mix_bwd.launches)
    seen = []
    with recording(lambda *a: seen.append(a)):
        outs = M.rwkv_mix(x, p, mix, lr, lb)
        assert [o.shape for o in outs] == [x.shape] * len(outs)
        assert outs[0].requires_grad
        wrt = [t for t in (x, p, lr) if t is not None]
        grads = torch.autograd.grad(outs, wrt, [torch.ones_like(o)
                                                for o in outs])
    assert [g.shape for g in grads] == [t.shape for t in wrt]
    K, R = (5, 16) if kind == "time" else (2, 0)
    assert seen == [("rwkv_mix", *M.rwkv_mix_cost(2, 8, 16, K, R, 2)),
                    ("rwkv_mix_bwd", *M.rwkv_mix_bwd_cost(2, 8, 16, K, R, 2))]
    assert (M.rwkv_mix.launches, M.rwkv_mix_bwd.launches) == before


def _cpu_args(D=16, R=32, dtype=torch.bfloat16):
    x, p, mix, lr, lb = _inputs("time", 2, 4, D, R, "carried", dtype=dtype)
    return dict(x=x.detach(), prev=p, rows=list(mix.unbind(0)),
                lr=lr.detach(), lora_B=lb)


@pytest.mark.parametrize("case,error", [
    ("taken", None), ("odd_d", ValueError), ("rank", None),
    ("float32", None), ("float16", TypeError), ("float64", TypeError),
    ("mixed", TypeError), ("strided", ValueError), ("offset", ValueError),
    ("lr_strided", ValueError)])
def test_what_the_kernel_takes(case, error):
    """The card's checks, on CPU tensors: float32 or bfloat16 (``wkv6``'s
    dtypes), every tensor of x's dtype, contiguous and 16-byte aligned, D a
    multiple of one 16-byte vector; any LoRA rank (off the tile kernels'
    ranks the products are a GEMM)."""
    dtype = {"float32": torch.float32, "float16": torch.float16,
             "float64": torch.float64}.get(case, torch.bfloat16)
    a = _cpu_args(D=12 if case == "odd_d" else 16,
                  R=8 if case == "rank" else 32, dtype=dtype)
    if case == "offset":
        a["x"] = torch.zeros(a["x"].numel() + 1,
                             dtype=torch.bfloat16)[1:].view(a["x"].shape)
    elif case == "mixed":
        a["x"] = a["x"].float()
    elif case == "strided":
        a["x"] = a["x"].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "lr_strided":
        a["lr"] = a["lr"].transpose(0, 1).contiguous().transpose(0, 1)
    if error is None:
        M._check_kernel("t", a["x"], a["prev"], a["rows"], a["lr"],
                        a["lora_B"])
        return
    with pytest.raises(error):
        M._check_kernel("t", a["x"], a["prev"], a["rows"], a["lr"],
                        a["lora_B"])


def test_products_are_the_einsum():
    """:func:`products` (the forward's and the backward's batched GEMM) is
    the composition's ``lr_i @ lora_B[i]``, laid out ``[K, B S, D]``."""
    x, p, mix, lr, lb = _inputs("time", 2, 5, 12, 8, "none")
    want = torch.einsum("bsfr,frd->bsfd", lr, lb)
    got = M.products(lr.detach(), lb)
    torch.testing.assert_close(got, want.reshape(10, 5, 12).transpose(0, 1))


@pytest.mark.parametrize("bad", ["mixes", "lr_shape", "lora_B_alone",
                                 "prev_shape", "device"])
def test_refusals(bad):
    x, p, mix, lr, lb = _inputs("time", 2, 4, 8, 8, "carried",
                                dtype=torch.float32)
    if bad == "mixes":
        mix = torch.zeros(6, 8)
    elif bad == "lr_shape":
        lr = lr[:, :, :4]
    elif bad == "lora_B_alone":
        lr = None
    elif bad == "prev_shape":
        p = p[:1]
    else:
        x = x.detach().to("meta")
    with pytest.raises(ValueError):
        M.rwkv_mix(x, p, mix, lr, lb)


@pytest.mark.parametrize("device,dtype,fused", [
    ("cpu", torch.float32, True), ("cpu", torch.bfloat16, True),
    ("cuda", torch.bfloat16, True), ("cuda", torch.float32, True),
    ("cuda", torch.float16, True), ("meta", torch.float32, True),
    ("meshed", torch.float32, False)])
def test_the_model_takes_the_op_by_what_it_sees(monkeypatch, device, dtype,
                                                 fused):
    """``models/rwkv.py`` calls the op on every tensor but a meshed one:
    on the CPU (its plain path), on shape-only tensors and on card tensors
    of every dtype the model runs (fake CUDA tensors stand in here: the op
    records its kernel); the plain composition on a meshed tensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import rwkv as R
    calls = []

    def spy(name, fn):
        return lambda *a: (calls.append(name), fn(*a))[1]
    monkeypatch.setattr(R, "rwkv_mix", spy("op", M.rwkv_mix))
    monkeypatch.setattr(R, "rwkv_mix_plain", spy("plain", M.rwkv_mix_plain))
    if device == "meshed":
        monkeypatch.setattr(R, "meshed", lambda t: True)
    dev = "cpu" if device == "meshed" else device
    D, F = 16, 32
    seen = []
    with contextlib.ExitStack() as stack:
        if dev == "cuda":
            stack.enter_context(FakeTensorMode())
        stack.enter_context(recording(lambda *a: seen.append(a[0])))
        p = {name: torch.zeros(shape, dtype=dtype, device=dev)
             for name, shape in (("cmix_k", (D,)), ("cmix_r", (D,)),
                                 ("ck", (D, F)), ("cv", (F, D)),
                                 ("cr", (D, D)))}
        x = torch.zeros(2, 4, D, dtype=dtype, device=dev)
        out = R.rwkv6_channel_mix(p, x)
        assert tuple(out.shape) == (2, 4, D)
    assert calls == (["op"] if fused else ["plain"])
    assert ("rwkv_mix" in seen) == (dev in ("cuda", "meta"))


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (B, S, D, R, prev, dtype): rwkv6-7b's training shape, a small odd one
# with a carried shift (sequences of 37 rows straddle the 64-row tiles and
# the 8-row walks) in each dtype the kernel takes and at a rank off the
# tile kernels', and the decode step's (one row a sequence, every row takes
# its carried shift)
BF16, F32 = torch.bfloat16, torch.float32
CARD_SHAPES = [(2, 8192, 4096, 64, "none", BF16),
               (3, 37, 200, 32, "carried", BF16),
               (3, 37, 200, 16, "carried", BF16),
               (3, 37, 200, 32, "carried", F32),
               (5, 1, 4096, 64, "carried", BF16)]
# one rounding of the dtype on store, and of the products and G
CARD_TOL = {BF16: 2 ** -7, F32: 2 ** -16}


def _rel_close(got, want, tol, what):
    err = (got.float() - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda, kind, shape):
    """The kernel's outputs, dx, dprev and dlr against the float32
    composition and the backward's float32 formulas on the same inputs:
    within ``CARD_TOL`` of each tensor's largest value; two calls give the
    same bytes; one launch a forward call, two a backward call of the tile
    kernels (the time mix in bf16 at a rank of ``RANKS``), one otherwise."""
    B, S, D, R, prev, dtype = shape
    x, p, mix, lr, lb = _inputs(kind, B, S, D, R, prev, dtype=dtype,
                                device=cuda, seed=3)
    x, lr = x.detach(), None if lr is None else lr.detach()
    f32 = [None if t is None else t.float() for t in (x, p, lr, lb)]
    mixf = (mix.float() if kind == "time"
            else tuple(m.float() for m in mix))
    before = (M.rwkv_mix.launches, M.rwkv_mix.kernel_launches,
              M.rwkv_mix_bwd.launches, M.rwkv_mix_bwd.kernel_launches)
    outs = M.rwkv_mix(x, p, mix, lr, lb)
    again = M.rwkv_mix(x, p, mix, lr, lb)
    want = M.rwkv_mix_plain(f32[0], f32[1], mixf, f32[2], f32[3])
    for i, (o, a, w) in enumerate(zip(outs, again, want)):
        assert o.dtype == dtype and torch.equal(o, a)
        _rel_close(o, w, CARD_TOL[dtype], f"out{i}")
    dys = [0.1 * torch.randn(x.shape, device=cuda).to(dtype) for _ in outs]
    got = M.rwkv_mix_bwd(x, p, mix, lr, lb, dys)
    got2 = M.rwkv_mix_bwd(x, p, mix, lr, lb, dys)
    torch.cuda.synchronize()
    ref = M.rwkv_mix_bwd_plain(f32[0], f32[1], mixf, f32[2], f32[3],
                               [d.float() for d in dys])
    for name, g, g2, w in zip(("dx", "dprev", "dlr"), got, got2, ref):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == dtype and torch.equal(g, g2), name
            _rel_close(g, w.float(), CARD_TOL[dtype], name)
    assert (M.rwkv_mix.launches - before[0],
            M.rwkv_mix.kernel_launches - before[1],
            M.rwkv_mix_bwd.launches - before[2],
            M.rwkv_mix_bwd.kernel_launches - before[3]) == \
        (2, 2, 2, 4 if M._tile(x, lr) else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_weight_grads_on_card(cuda, kind):
    """Under grad with every input training (a carried shift with its
    gradient, the static mixes, ``lora_B``): the card's gradients against
    autograd through the float32 composition, within 2^-6 of each one's
    largest value; one launch of each entry point."""
    args = _inputs(kind, 2, 70, 64, 32, "carried_grad", dtype=torch.bfloat16,
                   device=cuda, seed=5, grad_weights=True)
    leaves = _leaves(*args)
    x, p, mix, lr, lb = args
    before = (M.rwkv_mix.launches, M.rwkv_mix_bwd.launches)
    outs = M.rwkv_mix(*args)
    dys = [torch.randn(o.shape, device=cuda).to(o.dtype) for o in outs]
    got = torch.autograd.grad(outs, leaves, dys)
    f = [t.detach().float().requires_grad_() for t in leaves]
    fmap = {id(t): ft for t, ft in zip(leaves, f)}

    def as_f(t):
        return None if t is None else fmap.get(id(t), t.detach().float())
    mixf = (as_f(mix) if kind == "time" else tuple(as_f(m) for m in mix))
    want = composition(as_f(x), as_f(p),
                       mixf if kind == "time" else torch.stack(mixf),
                       as_f(lr), as_f(lb))
    wgrads = torch.autograd.grad(want, f, [d.float() for d in dys])
    for i, (g, w) in enumerate(zip(got, wgrads)):
        _rel_close(g, w, 2 ** -6, i)
    assert (M.rwkv_mix.launches - before[0],
            M.rwkv_mix_bwd.launches - before[1]) == (1, 1)


NODE = "autograd::engine::evaluate_function: "


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


@pytest.mark.cuda
def test_traced_step_keeps_every_row_under_the_mix_span(cuda):
    """A profiled LoRA step of a tiny bf16 rwkv model with the offload's
    recompute, read from the profiler's events: every forward kernel of the
    op (``rwkv_mix_fwd``, ``rwkv_mix_ew_fwd``; forward and recompute) lies
    under ``turnip.rwkv.mix``, and every backward kernel (``rwkv_mix_bwd``,
    ``rwkv_mix_seam``, ``rwkv_mix_ew_bwd``) under the backward node of an
    op that ran under it; the op opens no span of its own."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import build_model
    from repro_torch.models.lora import lora_init, make_lora_loss
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(reduced(get_arch("rwkv6-7b")), dtype="bfloat16",
                              n_layers=2)
    model = build_model(cfg, remat="offload", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    ad = lora_init(gen, params, rank=4)
    for ab in ad.values():
        ab["B"].normal_(generator=gen)
    opt = AdamW()
    step = make_train_step(model, opt,
                           loss_fn=make_lora_loss(model, params, rank=4))
    state = {"params": ad, "opt": opt.init(ad),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    tok = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                        device="cuda")
    batch = {"tokens": tok, "labels": tok}
    state, _ = step(state, batch)                       # warm up
    before = (M.rwkv_mix.launches, M.rwkv_mix_bwd.launches,
              M.rwkv_mix.kernel_launches, M.rwkv_mix_bwd.kernel_launches)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    L = cfg.n_layers
    # forward and recompute, two mixes a layer; backward, all but layer
    # 0's time mix (its input, the frozen embedding's, takes no gradient)
    assert (M.rwkv_mix.launches - before[0],
            M.rwkv_mix_bwd.launches - before[1]) == (4 * L, 2 * L - 1)
    kernels = (M.rwkv_mix.kernel_launches - before[2],
               M.rwkv_mix_bwd.kernel_launches - before[3])
    # a forward operator under grad, by (thread, sequence number)
    forward = {}
    for e in events:
        if (e.device_type().name == "CPU" and not e.is_user_annotation()
                and e.sequence_nr() >= 0 and e.fwd_thread_id() == 0
                and not e.name().startswith(NODE) and e.scope() == 0):
            key = (e.start_thread_id(), e.sequence_nr())
            if key not in forward or forward[key].start_ns() < e.start_ns():
                forward[key] = e
    nodes = [e for e in events if e.name() == NODE + "MixFnBackward"]
    # a kernel shares its runtime launch call's correlation id
    launches = {e.correlation_id(): e for e in events
                if e.device_type().name == "CPU" and "aunch" in e.name()
                and e.correlation_id() > 0}
    where = {"fwd": [], "bwd": []}
    for e in events:
        if e.device_type().name != "CUDA" or e.is_user_annotation():
            continue
        base = re.sub(r"^void |\(anonymous namespace\)::", "",
                      e.name()).split("<")[0].split("(")[0].strip()
        if not base.startswith("rwkv_mix"):
            continue
        way = "bwd" if "bwd" in base or "seam" in base else "fwd"
        launch = launches.get(e.correlation_id())
        assert launch is not None, (base, [
            (c.name(), c.linked_correlation_id()) for c in events
            if c.correlation_id() == e.correlation_id()])
        t, th = launch.start_ns(), launch.start_thread_id()
        if way == "fwd":
            where[way].append(_innermost_span(events, th, t))
            continue
        node = [n for n in nodes if n.start_thread_id() == th
                and n.start_ns() <= t <= n.end_ns()]
        assert len(node) == 1, node
        op = forward.get((node[0].fwd_thread_id(), node[0].sequence_nr()))
        assert op is not None
        where[way].append(_innermost_span(events, op.start_thread_id(),
                                          op.start_ns()))
    assert where["fwd"] == ["turnip.rwkv.mix"] * kernels[0], where
    assert where["bwd"] == ["turnip.rwkv.mix"] * kernels[1], where
    opened = {e.name() for e in events if e.is_user_annotation()
              and e.name().startswith("turnip.")}
    assert not any("rwkv_mix" in name for name in opened), opened
