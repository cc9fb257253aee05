"""olmo-1b [dense]: non-parametric LayerNorm, SwiGLU. [arXiv:2402.00838; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    norm="layernorm_np", mlp="swiglu", rope_theta=1e4,
    source="arXiv:2402.00838; hf",
)
