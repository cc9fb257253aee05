"""The train step: the port of ``repro/train/step.py``.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)`` over a state ``{"params", "opt", "step"}`` of dicts of tensors.
Gradients come from ``torch.autograd.grad`` of the loss with respect to
fresh leaves that share the parameters' storage; ``remat`` is the model's
own. ``grad_accum > 1`` runs the microbatches one after the other (the
reference scans them), sums the gradients in f32 and scales the loss and
the gradients by 1/n. Metrics: ``loss`` and ``grad_norm``, f32, the norm
over every gradient leaf.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..spans import span
from .optim import AdamW, apply_updates
from .tree import flatten, leaves, tree_map, unflatten

__all__ = ["init_train_state", "make_train_step", "value_and_grad"]


def init_train_state(model, gen: torch.Generator, optimizer=None) -> dict:
    params = model.init(gen)
    opt = (optimizer or AdamW()).init(params)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def value_and_grad(fn: Callable, params: Any, batch: dict):
    """``(fn(params, batch), d fn / d params)``: the loss detached, the
    gradients shaped like ``params`` (zeros for a leaf the loss does not
    reach)."""
    flat = [p.detach().requires_grad_() for _, p in flatten(params)]
    with span("turnip.step.forward"):
        loss = fn(unflatten(params, flat), batch)
    with span("turnip.step.backward"):
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads)


def _microbatches(batch: dict, n: int) -> list[dict]:
    def split(x):
        per = x.shape[0] // n
        return [x[j * per:(j + 1) * per] for j in range(n)]
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: parts[k][j] for k in batch} for j in range(n)]


def make_train_step(model, optimizer=None, *, grad_accum: int = 1,
                    loss_fn: Callable | None = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``."""
    opt = optimizer or AdamW()
    lfn = loss_fn or model.loss

    def compute_grads(params, batch):
        if grad_accum == 1:
            return value_and_grad(lfn, params, batch)
        loss = None
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for mb in _microbatches(batch, grad_accum):
            l, g = value_and_grad(lfn, params, mb)
            loss = l.float() if loss is None else loss + l
            g_acc = tree_map(torch.add, g_acc, g)
        scale = 1.0 / grad_accum
        return loss * scale, tree_map(lambda g: g * scale, g_acc)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        loss, grads = compute_grads(state["params"], batch)
        with span("turnip.step.optimizer"):
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                       for g in leaves(grads)))
            updates, opt_state = opt.update(grads, state["opt"],
                                            state["params"])
            params = apply_updates(state["params"], updates)
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1},
                {"loss": loss, "grad_norm": gnorm})

    return train_step
