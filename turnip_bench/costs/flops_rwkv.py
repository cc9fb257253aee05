"""RWKV-6's multiply-adds (``model_flops``'s rules): per layer the
token-shift LoRA (``time_mix_extra_dim`` x 5 mixes), the decay LoRA
(``time_decay_extra_dim``), the r, k, v, gate and output projections, the
channel mix's three products, and the WKV recurrence in its linear-time
form (the state update and the output, ``2 P P`` a token and head); the
head over the vocabulary. The adapters sit on every layer's wk and wv."""
from __future__ import annotations


def macs(config: dict, S: int) -> dict:
    arch = config["as_run"]
    D, F, V, L = (arch["d_model"], arch["d_ff"], arch["vocab_size"],
                  arch["n_layers"])
    P = arch["rwkv_headdim"]
    H = D // P
    r, rw = config["time_mix_extra_dim"], config["time_decay_extra_dim"]
    layer = (D * 5 * r + 5 * r * D + D * rw + rw * D + 5 * D * D
             + D * F + F * D + D * D)
    return {"products": S * (L * layer + D * V), "conv": 0,
            "attention": 0, "scan": S * L * 2 * H * P * P}


def lora_macs(config: dict, S: int, rank: int) -> float:
    arch = config["as_run"]
    D = arch["d_model"]
    return S * arch["n_layers"] * rank * 2 * (D + D)
