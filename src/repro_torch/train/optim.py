"""Pure optimizers on dicts of tensors: the port of ``repro/train/optim.py``.

AdamW and Lion with the reference's arithmetic: f32 moments, the update
computed in f32 and cast to the parameter's dtype, AdamW's bias correction
``1 − β^t`` in f32 and its decoupled weight decay added to the
bias-corrected step before the learning rate scales it (not
``torch.optim.AdamW``'s order, which decays the parameter first). States are
dicts shaped like the parameters, plus an int32 ``count``; nothing is
updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .tree import leaves, tree_map

__all__ = ["AdamW", "Lion", "apply_updates"]


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _count(params: Any) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: Any) -> dict:
        return {"m": tree_map(_f32_zeros, params),
                "v": tree_map(_f32_zeros, params),
                "count": _count(params)}

    @torch.no_grad()
    def update(self, grads: Any, state: dict, params: Any) -> tuple[Any, dict]:
        c = state["count"] + 1
        b1c = 1.0 - self.b1 ** c.float()
        b2c = 1.0 - self.b2 ** c.float()
        m2 = tree_map(lambda g, m: self.b1 * m + (1 - self.b1) * g.float(),
                      grads, state["m"])
        v2 = tree_map(lambda g, v: self.b2 * v
                      + (1 - self.b2) * torch.square(g.float()),
                      grads, state["v"])

        def upd(m, v, p):
            step = (m / b1c) / (torch.sqrt(v / b2c) + self.eps) \
                + self.weight_decay * p.float()
            return (-self.lr * step).to(p.dtype)
        updates = tree_map(upd, m2, v2, params)
        return updates, {"m": m2, "v": v2, "count": c}


@dataclasses.dataclass(frozen=True)
class Lion:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.99
    weight_decay: float = 0.1

    def init(self, params: Any) -> dict:
        return {"m": tree_map(_f32_zeros, params), "count": _count(params)}

    @torch.no_grad()
    def update(self, grads: Any, state: dict, params: Any) -> tuple[Any, dict]:
        def upd(g, m, p):
            u = torch.sign(self.b1 * m + (1 - self.b1) * g.float()) \
                + self.weight_decay * p.float()
            return (-self.lr * u).to(p.dtype)
        updates = tree_map(upd, grads, state["m"], params)
        m2 = tree_map(lambda g, m: self.b2 * m + (1 - self.b2) * g.float(),
                      grads, state["m"])
        return updates, {"m": m2, "count": state["count"] + 1}


@torch.no_grad()
def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
