"""Carry the reference's state across to the port.

The reference package draws a graph's inputs as numpy arrays
(``Traced.make_inputs``); the port runs on torch tensors. The two graphs
are equal vertex for vertex, so the tids match, and
:func:`inputs_from_reference` turns the reference's dict into the port's
host tensors: pinned when the runtime's device is CUDA (an h2d copy from
pinned memory is asynchronous), plain on the CPU.

bfloat16 arrays from JAX are numpy arrays of an ``ml_dtypes`` type. They
are recognised by their dtype's *name* and moved through a ``uint16``
view, so this module never imports ``ml_dtypes``. :func:`params_from_reference`
carries a model's parameter pytree across the same way. The same conversions
serve the disk tier, which writes raw bytes through numpy.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import resolve_device

__all__ = ["inputs_from_reference", "params_from_reference", "host_tensor",
           "numpy_bytes", "tensor_from_bytes", "dtype_name"]


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # torch tensors share, and may write
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def host_tensor(value: Any, *, pin: bool) -> torch.Tensor:
    """A host tensor for ``value`` (a numpy array or a CPU tensor). With
    ``pin``, a numpy array is copied into pinned memory and a tensor must
    already be pinned."""
    if isinstance(value, torch.Tensor):
        if value.device.type != "cpu":
            raise ValueError(f"host tensors live on the CPU, not {value.device}")
        if pin and not value.is_pinned():
            raise ValueError("a CUDA host store needs pinned tensors "
                             "(see inputs_from_reference)")
        return value
    t = _from_numpy(np.asarray(value))
    return t.pin_memory() if pin else t


def inputs_from_reference(inputs: dict[int, np.ndarray], *,
                          device: str | torch.device | None = None
                          ) -> dict[int, torch.Tensor]:
    """The reference's ``make_inputs`` dict as the port's host tensors for
    a runtime on ``device`` (default CUDA): pinned for CUDA, plain on the
    CPU."""
    pin = resolve_device(device).type == "cuda"
    return {tid: host_tensor(a, pin=pin) for tid, a in inputs.items()}


def params_from_reference(params: dict, *,
                          device: str | torch.device | None = None) -> dict:
    """The reference's ``LM.init`` pytree, its leaves as numpy arrays
    (``jax.tree.map(np.asarray, params)``; bfloat16 through its ``uint16``
    view), as the port's parameter dict on ``device`` (default CUDA): the
    same keys, the same nesting, the same values."""
    dev = resolve_device(device)
    return {k: (params_from_reference(v, device=dev) if isinstance(v, dict)
                else _from_numpy(np.asarray(v)).to(dev))
            for k, v in params.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's name as numpy (and ml_dtypes) spell it:
    ``"bfloat16"``, ``"float32"``."""
    return str(dtype).removeprefix("torch.")


def numpy_bytes(t: torch.Tensor) -> tuple[str, np.ndarray]:
    """``t`` as (dtype name, contiguous numpy array of its bytes)."""
    t = t.detach().cpu().contiguous()
    name = dtype_name(t.dtype)
    if t.dtype == torch.bfloat16:
        return name, t.view(torch.uint16).numpy()
    return name, t.numpy()


def tensor_from_bytes(buf: bytes, dtype: str, shape) -> torch.Tensor:
    """The inverse of :func:`numpy_bytes`: a fresh CPU tensor."""
    tdt = getattr(torch, dtype)
    if tdt == torch.bfloat16:
        a = np.frombuffer(buf, dtype=np.uint16).copy()
        return torch.from_numpy(a).view(torch.bfloat16).reshape(shape)
    np_dt = torch.empty((), dtype=tdt).numpy().dtype
    a = np.frombuffer(buf, dtype=np_dt).copy()
    return torch.from_numpy(a).reshape(shape)
