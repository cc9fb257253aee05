"""The plain float32 reference's shared parts: the benchmark's weights and
adapters, the layers the families use, the lower-precision control's
products, the optimizer, and the layer-by-layer training step.

Plain torch only: nothing here imports the program, and nothing calls a
kernel of it. Float32 products run with TF32 off (:func:`exact`).
"""
from __future__ import annotations

import math

import torch

__all__ = ["exact", "make_weights", "make_adapters", "Lin", "rmsnorm",
           "layernorm", "nll_sum", "train", "LORA_TARGETS"]

# the program's LoRA targets (``repro_torch/models/lora.py``): every weight
# with one of these names gets an adapter
LORA_TARGETS = ("wq", "wk", "wv", "wi", "wi_gate", "wi_up")
E4M3_MAX = 448.0


def exact() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------- weights
def make_weights(specs: list[tuple], gen: torch.Generator,
                 device: torch.device) -> dict:
    """A nested dict of tensors from ``specs``: ``(path, shape, dtype,
    kind, arg)`` with ``kind`` one of ``normal`` (N(0, arg^2)),
    ``uniform`` (U(0, 1)), ``ones``, ``zeros`` or ``value`` (``arg``, a
    tensor on the CPU, copied). The normal leaves of one dtype are views
    of one draw, and the uniform ones of another, made on ``device`` by
    ``gen`` in spec order: the same seed gives the same weights."""
    out: dict = {}
    draws: dict[tuple, list] = {}
    for path, shape, dtype, kind, arg in specs:
        if kind in ("normal", "uniform"):
            draws.setdefault((kind, dtype), []).append((path, shape, arg))
        elif kind == "ones":
            _put(out, path, torch.ones(shape, dtype=dtype, device=device))
        elif kind == "zeros":
            _put(out, path, torch.zeros(shape, dtype=dtype, device=device))
        elif kind == "value":
            _put(out, path, arg.to(device=device, dtype=dtype))
        else:
            raise ValueError(f"unknown weight kind {kind!r}")
    for (kind, dtype), leaves in draws.items():
        total = sum(math.prod(s) for _, s, _ in leaves)
        draw = torch.randn if kind == "normal" else torch.rand
        flat = draw(total, generator=gen, dtype=dtype, device=device)
        off = 0
        for path, shape, scale in leaves:
            n = math.prod(shape)
            leaf = flat[off:off + n].view(shape)
            if kind == "normal":
                leaf.mul_(scale)
            _put(out, path, leaf)
            off += n
    return out


def _put(tree: dict, path: str, leaf: torch.Tensor) -> None:
    *keys, last = path.split("/")
    for k in keys:
        tree = tree.setdefault(k, {})
    tree[last] = leaf


def flat_items(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``[(path, leaf)]`` in sorted key order."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        v = tree[k]
        out += flat_items(v, path) if isinstance(v, dict) else [(path, v)]
    return out


def make_adapters(params: dict, gen: torch.Generator, rank: int,
                  b_scale: float) -> dict:
    """Rank-``rank`` adapters on every targeted weight ``[.., d_in,
    d_out]``: A ``[.., r, d_in]`` N(0, 1/d_in), B ``[.., d_out, r]``
    N(0, b_scale^2) (nonzero, so that every leaf has a gradient from the
    first step), float32, drawn on the generator's device in sorted path
    order. ``{path: {"A", "B"}}``, the program's adapter layout."""
    out = {}
    for path, leaf in flat_items(params):
        if path.rsplit("/", 1)[-1] not in LORA_TARGETS or leaf.dim() < 2:
            continue
        *stack, d_in, d_out = leaf.shape
        a = torch.randn((*stack, rank, d_in), generator=gen,
                        device=gen.device) / math.sqrt(d_in)
        b = torch.randn((*stack, d_out, rank), generator=gen,
                        device=gen.device) * b_scale
        out[path] = {"A": a.to(leaf.device), "B": b.to(leaf.device)}
    return out


# ------------------------------------------------------------ products
def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, scaled by its largest magnitude along
    ``dim``, and back; the gradient passes straight through."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    s = amax / E4M3_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()


class Lin:
    """``x @ w`` in float32 (``precision='fp32'``), or with both operands
    rounded to float8 e4m3 first (``'fp8'``: x scaled per row, w per
    output column), the lower-precision control."""

    def __init__(self, precision: str = "fp32") -> None:
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.fp8:
            return _q8(x, -1) @ _q8(w, 0)
        return x @ w


# -------------------------------------------------------------- layers
def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * g.float()


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def nll_sum(logits: torch.Tensor, labels: torch.Tensor,
            vocab: int) -> torch.Tensor:
    """Summed ``-log softmax(logits[..., :vocab])[label]``."""
    logits = logits[..., :vocab]
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - tgt).sum()


# ----------------------------------------------------------- training
def _adamw(p, g, m, v, t: int, hp: dict):
    """One AdamW step in float32: the decoupled decay added to the
    bias-corrected step, then scaled by the learning rate."""
    b1, b2 = hp["b1"], hp["b2"]
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    step = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + hp["eps"]) \
        + hp["weight_decay"] * p
    return p - hp["lr"] * step, m, v


def train(model, batches: list[dict], adapters0: dict, hp: dict,
          steps: int, *, head_block: int = 2048) -> dict:
    """``steps`` LoRA steps of ``model`` (a family reference built on the
    base weights) from ``adapters0``, AdamW with ``hp``, one batch a step.
    The base is frozen. Each step's forward keeps only each layer's input
    and recomputes the layer in the backward, one layer at a time.

    Returns ``{"loss": [per step], "grad1": {path: {"A", "B"}} the first
    step's gradients, "adapters": the adapters after the last step}``,
    all float32."""
    ad = {p: {k: t.detach().float().clone() for k, t in ab.items()}
          for p, ab in adapters0.items()}
    keys = [(p, k) for p in sorted(ad) for k in ("A", "B")]
    mom = {pk: torch.zeros_like(ad[pk[0]][pk[1]]) for pk in keys}
    vel = {pk: torch.zeros_like(ad[pk[0]][pk[1]]) for pk in keys}
    out: dict = {"loss": []}
    for t in range(1, steps + 1):
        batch = batches[t - 1]
        leaves = {pk: ad[pk[0]][pk[1]].requires_grad_() for pk in keys}
        loss, grads = _loss_and_grads(model, batch, ad, leaves, head_block)
        out["loss"].append(loss)
        if t == 1:
            out["grad1"] = {p: {k: grads[(p, k)].clone() for k in ("A", "B")}
                            for p in ad}
        with torch.no_grad():
            for pk in keys:
                p = ad[pk[0]][pk[1]].detach()
                ad[pk[0]][pk[1]], mom[pk], vel[pk] = _adamw(
                    p, grads[pk], mom[pk], vel[pk], t, hp)
    out["adapters"] = {p: {k: t.detach() for k, t in ab.items()}
                       for p, ab in ad.items()}
    return out


def _loss_and_grads(model, batch, ad, leaves, head_block):
    tokens, labels = batch["tokens"], batch["labels"]
    n_tok = labels.numel()
    layers = model.layers(ad)
    with torch.no_grad():
        h = model.embed(tokens)
        inputs = []
        for f in layers:
            inputs.append(h)
            h = f(h)
    grads = {pk: torch.zeros_like(t) for pk, t in leaves.items()}
    dh = torch.zeros_like(h)
    loss = 0.0
    for s0 in range(0, h.shape[1], head_block):
        hb = h[:, s0:s0 + head_block].detach().requires_grad_()
        lb = nll_sum(model.head(hb), labels[:, s0:s0 + head_block],
                     model.vocab) / n_tok
        dh[:, s0:s0 + head_block] = torch.autograd.grad(lb, hb)[0]
        loss += float(lb.detach())
    order = list(leaves)
    for i in range(len(layers) - 1, -1, -1):
        x = inputs[i].requires_grad_(i > 0)
        inputs[i] = None
        with torch.enable_grad():
            y = layers[i](x)
        if not y.requires_grad:
            continue
        want = ([x] if i > 0 else []) + [leaves[pk] for pk in order]
        got = torch.autograd.grad(y, want, dh, allow_unused=True)
        if i > 0:
            dh, got = got[0], got[1:]
        for pk, g in zip(order, got):
            if g is not None:
                grads[pk] += g
        del y, x
    return loss, grads


def lora_weight(w: torch.Tensor, ab: dict | None, scale: float,
                index: int | None = None) -> torch.Tensor:
    """The weight a layer uses, float32: ``w + scale (B A)^T`` where an
    adapter ``ab`` targets it, else ``w``; ``index`` takes one layer of a
    stacked leaf and its adapter."""
    wf = (w if index is None else w[index]).float()
    if ab is None:
        return wf
    a = ab["A"] if index is None else ab["A"][index]
    b = ab["B"] if index is None else ab["B"][index]
    return wf + scale * (b @ a).transpose(-1, -2)

