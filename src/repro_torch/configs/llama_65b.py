"""llama-65b: the paper's large evaluation model (§8). [arXiv:2302.13971]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-65b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=64,
    d_ff=22016, vocab_size=32000,
    norm="rmsnorm", mlp="swiglu", rope_theta=1e4,
    source="arXiv:2302.13971 (paper §8)",
)
