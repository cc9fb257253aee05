"""rwkv6-7b [ssm]: RWKV-6 "Finch" — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="rwkv",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,  # heads = D/headdim
    d_ff=14336, vocab_size=65536,
    norm="layernorm", mlp="swiglu", rope_theta=0.0,
    rwkv_headdim=64, subquadratic=True,
    source="arXiv:2404.05892; hf",
)
