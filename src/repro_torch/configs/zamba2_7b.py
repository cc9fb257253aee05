"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention block invoked
periodically. [arXiv:2411.15242; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="zamba",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    norm="rmsnorm", mlp="swiglu", rope_theta=1e4,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, zamba_group=6,
    subquadratic=True,
    source="arXiv:2411.15242; unverified",
)
