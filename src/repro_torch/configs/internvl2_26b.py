"""internvl2-26b [vlm]: InternViT frontend (stubbed) + InternLM2-20B-style
LM backbone. [arXiv:2404.16821; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553,
    norm="rmsnorm", mlp="swiglu", qkv_bias=False, rope_theta=1e6,
    frontend="vit", n_frontend_tokens=256,
    source="arXiv:2404.16821; hf",
)
