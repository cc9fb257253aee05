"""LoRA adapters for the port's LM: the port of ``repro/models/lora.py``.

Rank-r adapters on the attention projections (wq, wk, wv) and the FFN
up-projections (wi, wi_gate, wi_up), with the reference's targets, keys
(``"layers/attn/wq"``, ...), shapes (A ``[.., r, d_in]`` gaussian / √d_in,
B ``[.., d_out, r]`` zeros) and merged form
``W' = (W + (α/r)·(BA)ᵀ).to(W.dtype)``. The adapters are a flat dict
``{path: {"A": .., "B": ..}}``, as the reference's.

Where the merge happens is the port's own. The reference merges every
stacked ``[L, ..]`` leaf before the forward (XLA keeps what it needs).
Here a stacked leaf of a model's layers (``layers/...``) becomes a
:class:`MergedStack`, which merges one layer's slice when the layer body
takes it (``stack[i]``). The merged weights of a layer then live only
while that layer runs (and, under ``remat``, are recomputed with it), and
the gradient of a layer's merged weights reaches its A and B at once,
never as a ``[L, ..]`` tensor. Other leaves (Zamba2's shared block) are
merged whole. The function is the same: the merge of layer i is the
reference's merge of the stack, sliced.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..spans import span
from ..train.tree import flatten

__all__ = ["lora_init", "lora_apply", "make_lora_loss", "merge",
           "MergedStack"]

_TARGETS = ("wq", "wk", "wv", "wi", "wi_gate", "wi_up")
# prefixes of the leaves stacked along a model's layers and taken one layer
# at a time by LM.apply
_LAYER_STACKS = ("layers/",)


def lora_init(gen: torch.Generator, base_params: dict, *, rank: int = 16,
              dtype=torch.float32) -> dict:
    """Adapters for each targeted weight ``[.., d_in, d_out]`` (2-D or
    stacked): A ``[.., r, d_in]`` drawn N(0, 1)/√d_in from ``gen`` (on the
    generator's device, in the leaf order of the reference), B
    ``[.., d_out, r]`` zeros; both on the leaf's device, in ``dtype``."""
    out: dict[str, dict[str, torch.Tensor]] = {}
    for path, leaf in flatten(base_params):
        name = path.rsplit("/", 1)[-1]
        if name not in _TARGETS or leaf.dim() < 2:
            continue
        *stack, d_in, d_out = leaf.shape
        a = torch.randn((*stack, rank, d_in), generator=gen, dtype=dtype,
                        device=gen.device) / math.sqrt(d_in)
        out[path] = {"A": a.to(leaf.device),
                     "B": torch.zeros((*stack, d_out, rank), dtype=dtype,
                                      device=leaf.device)}
    return out


def merge(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          scale: float) -> torch.Tensor:
    """``(w + scale·(b a)ᵀ).to(w.dtype)`` over any leading dims. The
    product is batched (``bmm``) as the reference's ``einsum('...or,
    ...ri->...io')`` is, so that ``remat='dots'`` does not save it."""
    d_out, r = b.shape[-2:]
    d_in = a.shape[-1]
    with span("turnip.lora.merge"):
        delta = torch.bmm(b.reshape(-1, d_out, r), a.reshape(-1, r, d_in))
        delta = delta.reshape(*b.shape[:-2], d_out, d_in).transpose(-1, -2)
        return (w + scale * delta).to(w.dtype)


class MergedStack:
    """A stacked base leaf ``[L, .., d_in, d_out]`` with its adapters,
    merged one layer at a time: ``stack[i]`` is ``merge(w[i], a[i], b[i])``.
    ``full()`` merges the whole stack (the reference's ``lora_apply``
    leaf)."""

    def __init__(self, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 scale: float) -> None:
        self.w, self.a, self.b, self.scale = w, a, b, scale

    @property
    def shape(self) -> torch.Size:
        return self.w.shape

    def __getitem__(self, i: int) -> torch.Tensor:
        return merge(self.w[i], self.a[i], self.b[i], self.scale)

    def full(self) -> torch.Tensor:
        return merge(self.w, self.a, self.b, self.scale)


def lora_apply(base_params: dict, adapters: dict, *, alpha: float = 16.0,
               rank: int = 16) -> dict:
    """Effective parameters ``W' = W + (α/r)·(BA)ᵀ`` for every adapted
    leaf; the other leaves are the base's own tensors. Layer stacks come
    back as :class:`MergedStack` (merged when a layer takes its slice),
    the rest merged. Gradients flow to A and B through the merge."""
    scale = alpha / rank

    def walk(tree: dict, prefix: str) -> dict:
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = walk(v, path)
            elif path in adapters:
                a, b = adapters[path]["A"], adapters[path]["B"]
                if path.startswith(_LAYER_STACKS):
                    out[k] = MergedStack(v, a, b, scale)
                else:
                    out[k] = merge(v, a, b, scale)
            else:
                out[k] = v
        return out
    return walk(base_params, "")


def make_lora_loss(model, base_params: dict, *, alpha: float = 16.0,
                   rank: int = 16):
    """``loss(adapters, batch)``: the model's loss through the merge; the
    base parameters are constants of the closure."""
    def loss(adapters: dict, batch: dict) -> torch.Tensor:
        eff = lora_apply(base_params, adapters, alpha=alpha, rank=rank)
        return model.loss(eff, batch)
    return loss
