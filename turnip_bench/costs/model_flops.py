"""Closed-form model FLOPs, for ``mfu``: the rules shared by every family,
and each family's multiply-adds in a file of its own,
``costs/flops_<family>.py``, found by the family's name.

Counted: the products of the model's mathematics, two operations a
multiply-add, over the true vocabulary: every projection and MLP product,
any depthwise convolution, attention's products over the pairs it needs,
the recurrences in their linear-time form, the head, and a LoRA adapter as
its two low-rank products (``x A^T`` then ``B``). Not counted: norms,
activations and other elementwise work, the merge of an adapter into its
weight, anything the program recomputes (``remat``) and any work an
implementation adds.

A LoRA training step on a frozen base is the forward, plus the backward's
activation gradients (each product's once more; attention's and the
recurrences' twice: four products in the backward against two), plus the
adapters' gradients (twice their forward products: dA and dB). The base
weights take no gradient.

``config`` is a configuration file (``configs/<name>.json``); a family's
file exposes ``macs(config, S)``, the multiply-adds of one forward over a
sequence of ``S`` tokens by kind (``products`` and ``conv``, which a frozen
base's backward repeats once; ``attention`` and ``scan``, repeated
twice), and ``lora_macs(config, S, rank)``, those of the adapters'
forward over every call of each targeted weight.
"""
from __future__ import annotations

import importlib

__all__ = ["family", "forward_flops", "lora_step_flops"]


def family(config: dict):
    """``costs/flops_<family>.py`` of the configuration's family."""
    return importlib.import_module(
        f".flops_{config['as_run']['family']}", __package__)


def forward_flops(config: dict, S: int) -> float:
    """FLOPs of one forward over a sequence of ``S`` tokens (no LoRA)."""
    return 2.0 * sum(family(config).macs(config, S).values())


def lora_step_flops(config: dict, S: int, rank: int) -> float:
    """FLOPs of one LoRA training step's forward and backward on one
    sequence of ``S`` tokens, the base frozen."""
    fam = family(config)
    m = fam.macs(config, S)
    once = m["products"] + m["conv"]
    twice = m["attention"] + m["scan"]
    lora = fam.lora_macs(config, S, rank)
    return 2.0 * ((once + twice + lora)              # forward
                  + (once + 2 * twice + 2 * lora))   # backward
