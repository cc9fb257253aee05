"""The harness's CPU tests: a tiny model of the benchmark's rwkv family,
run through the same driver and reference on the CPU. Tests that need the
card carry the ``cuda`` marker and skip inside their fixture without one."""
from __future__ import annotations

import copy
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TRAIN = "rwkv6-7b.lora-offload.2x8192"
TINY = {"name": "rwkv-tiny", "family": "rwkv", "n_layers": 8,
        "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 224,
        "vocab_size": 256, "norm": "layernorm", "mlp": "swiglu",
        "rope_theta": 0.0, "rwkv_headdim": 16, "subquadratic": True,
        "dtype": "float32"}
# the tiny model's token-shift and decay LoRA sizes, cut with its width;
# 8 layers, so that the control's rounding grows through depth as it does
# in the cell's 32 (at 2 layers it reads under the cell's limits)
TINY_LORA = {"time_mix_extra_dim": 16, "time_decay_extra_dim": 32}


def tiny_config(dtype: str = "float32") -> dict:
    """``configs/rwkv6-7b.json`` with its model cut to ``TINY``."""
    from turnip_bench import harness
    config = copy.deepcopy(json.loads(
        (harness.HERE / "configs" / "rwkv6-7b.json").read_text()))
    config.update(TINY_LORA, as_run=dict(TINY, dtype=dtype))
    return config


def tiny_cell(*, seed: int = 1234567891, seconds: float = 0.0,
              trace: bool = False, traffic: dict | None = None,
              dtype: str = "float32"):
    """The training cell of ``BENCHMARK.json`` with its configuration cut
    to the tiny model (float32 by default) and its traffic to short
    sequences, on the CPU."""
    from turnip_bench import harness
    cell = harness.load_cell(TRAIN, seed, seconds, trace)
    cell.config = tiny_config(dtype)
    cell.traffic = {**cell.traffic, "seq_len": 64, "pool": 4, **(traffic or {})}
    return cell


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
