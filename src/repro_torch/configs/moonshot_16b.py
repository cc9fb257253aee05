"""moonshot-v1-16b-a3b [moe]: kimi/moonlight — 64 experts, top-6,
per-expert d_ff=1408. [hf:moonshotai/Moonlight-16B-A3B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840,
    norm="rmsnorm", mlp="swiglu", rope_theta=5e4,
    n_experts=64, top_k=6,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
