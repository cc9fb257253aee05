"""The closed-form model FLOPs against ``torch.utils.flop_counter`` on the
plain reference of a tiny configuration: the products as counted, the
recurrence (which the reference computes in chunks, with more products
than its linear form) replaced by a stand-in that counts nothing."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from turnip_bench.costs import model_flops
from turnip_bench.reference import common, rwkv

from conftest import tiny_config


def test_forward_flops_match_the_counter(monkeypatch):
    config = tiny_config()
    gen = torch.Generator().manual_seed(0)
    params = common.make_weights(rwkv.weight_specs(config), gen,
                                 torch.device("cpu"))
    model = rwkv.Reference(config["as_run"], params)
    monkeypatch.setattr(rwkv, "wkv", lambda x, *a, **k: x * 0)
    S = 7
    tokens = torch.zeros(1, S, dtype=torch.long)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        h = model.embed(tokens)
        for f in model.layers():
            h = f(h)
        model.head(h)
    m = model_flops.family(config).macs(config, S)
    assert fc.get_total_flops() == 2 * m["products"]
    assert model_flops.forward_flops(config, S) == 2 * sum(m.values())


def test_lora_step_is_forward_plus_backward():
    config = tiny_config()
    S = 64
    fam = model_flops.family(config)
    m = fam.macs(config, S)
    lora = fam.lora_macs(config, S, 16)
    fwd = model_flops.forward_flops(config, S)
    assert model_flops.lora_step_flops(config, S, 16) == pytest.approx(
        2 * fwd + 2 * (m["attention"] + m["scan"]) + 6 * lora)


def test_a_family_is_found_by_its_name():
    config = tiny_config()
    assert model_flops.family(config).__name__.endswith(".flops_rwkv")
    config["as_run"]["family"] = "nosuch"
    with pytest.raises(ModuleNotFoundError):
        model_flops.forward_flops(config, 8)
