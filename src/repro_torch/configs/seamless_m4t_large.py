"""seamless-m4t-large-v2 [audio]: enc-dec transformer backbone; the conformer
audio frontend is a STUB (input_specs provides precomputed frame embeddings).
[arXiv:2308.11596; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    norm="layernorm", mlp="gelu", rope_theta=1e4,
    n_decoder_layers=24,
    source="arXiv:2308.11596; hf",
)
