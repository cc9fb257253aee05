"""qwen2.5-3b [dense]: GQA(kv=2), QKV bias, SwiGLU, RMSNorm.
[hf:Qwen/Qwen2.5-0.5B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab_size=151936,
    norm="rmsnorm", mlp="swiglu", qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
