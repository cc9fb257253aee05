"""llama-7b: the paper's own evaluation model (§8). [arXiv:2302.13971]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=32000,
    norm="rmsnorm", mlp="swiglu", rope_theta=1e4,
    source="arXiv:2302.13971 (paper §8)",
)
