"""starcoder2-3b [dense]: GQA(kv=2) + RoPE, layernorm + gelu MLP.
[arXiv:2402.19173; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab_size=49152,
    norm="layernorm", mlp="gelu", qkv_bias=True, rope_theta=1e5,
    source="arXiv:2402.19173; hf",
)
