"""Architecture + shape configuration (the assigned 10-arch × 4-shape grid).

Every architecture is an :class:`ArchConfig`; every workload shape a
:class:`ShapeConfig`. ``reduced(arch)`` gives the tiny same-family config
used by CPU smoke tests. ``input_specs(arch, shape)`` gives the step
function's inputs as meta-device tensors, PyTorch's counterpart of the
reference's ``ShapeDtypeStruct`` stand-ins (for the dry-run, ROADMAP A13).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "reduced",
           "applicable_shapes", "input_specs"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | rwkv | zamba | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    norm: str = "rmsnorm"         # rmsnorm | layernorm | layernorm_np
    mlp: str = "swiglu"           # swiglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 1e6
    # moe
    n_experts: int = 0
    top_k: int = 0
    # ssm (zamba) / rwkv
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    zamba_group: int = 6          # mamba layers per shared-attn invocation
    rwkv_headdim: int = 64
    # enc-dec
    n_decoder_layers: int = 0
    # modality stub frontend (assignment: frontend embeddings are provided)
    frontend: str | None = None   # vit | audio
    n_frontend_tokens: int = 256
    dtype: str = "bfloat16"
    subquadratic: bool = False    # may run long_500k
    source: str = ""              # citation tag from the assignment

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def param_count(self) -> float:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, f, V = self.d_model, self.d_ff, self.padded_vocab
        H, K, Dh = self.n_heads, self.n_kv_heads, self.d_head
        attn = d * H * Dh + 2 * d * K * Dh + H * Dh * d
        mlp = 3 * d * f if self.mlp == "swiglu" else 2 * d * f
        if self.family == "dense":
            per_layer = attn + mlp
            n = self.n_layers * per_layer
        elif self.family == "moe":
            expert = 3 * d * f
            per_layer = attn + self.n_experts * expert + d * self.n_experts
            n = self.n_layers * per_layer
        elif self.family == "rwkv":
            per_layer = 5 * d * d + 2 * d * f + 7 * 32 * d   # approx loras
            n = self.n_layers * per_layer
        elif self.family == "zamba":
            di = self.ssm_expand * d
            ssm = d * (2 * di + 2 * self.ssm_state + di // self.ssm_headdim) \
                + di * d
            shared = attn + mlp
            n = self.n_layers * ssm + shared
        elif self.family == "encdec":
            enc = self.n_layers * (attn + mlp)
            dec = self.n_decoder_layers * (2 * attn + mlp)
            n = enc + dec
        else:
            raise ValueError(self.family)
        return float(n + V * d)

    @property
    def active_param_count(self) -> float:
        """Active params per token (= params for non-MoE)."""
        if self.family != "moe":
            return self.param_count
        d, f = self.d_model, self.d_ff
        expert = 3 * d * f
        inactive = self.n_layers * (self.n_experts - self.top_k) * expert
        return self.param_count - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(arch: ArchConfig) -> list[str]:
    """long_500k needs sub-quadratic attention (assignment rule); skips are
    recorded in DESIGN.md §Arch-applicability."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch.subquadratic:
        out.append("long_500k")
    return out


def _meta(shape, dtype: str) -> torch.Tensor:
    return torch.empty(tuple(int(n) for n in shape),
                       dtype=getattr(torch, dtype), device="meta")


def input_specs(arch: ArchConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Meta-device stand-ins for every model input of the step function
    (the reference's ``input_specs``: the same keys, shapes and dtypes;
    weights and caches are made separately). Frontends are stubs: an
    enc-dec model takes ``S/2`` frame embeddings and ``S/2`` tokens, a
    ``vit`` model ``n_frontend_tokens`` vision embeddings before
    ``S - n_frontend_tokens`` tokens."""
    B, S = shape.global_batch, shape.seq_len
    adt, D = arch.dtype, arch.d_model
    if shape.kind == "decode":       # one new token against a deep cache
        return {"token": _meta((B, 1), "int32"),
                "cache_len": _meta((), "int32")}
    if arch.family == "encdec":
        specs = {"encoder_embeds": _meta((B, S // 2, D), adt),
                 "tokens": _meta((B, S // 2), "int32")}
    elif arch.frontend == "vit":
        nf = arch.n_frontend_tokens
        specs = {"vision_embeds": _meta((B, nf, D), adt),
                 "tokens": _meta((B, S - nf), "int32")}
    else:
        specs = {"tokens": _meta((B, S), "int32")}
    if shape.kind == "train":
        specs["labels"] = _meta(specs["tokens"].shape, "int32")
    return specs


def reduced(arch: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw: dict[str, Any] = dict(
        name=arch.name + "-smoke", family=arch.family,
        n_layers=min(arch.n_layers, 2 if arch.family != "zamba" else 5),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(arch.n_kv_heads, 2) if arch.n_kv_heads < arch.n_heads
        else 4,
        d_ff=256, vocab_size=512,
        norm=arch.norm, mlp=arch.mlp, qkv_bias=arch.qkv_bias,
        rope_theta=arch.rope_theta, dtype="float32",
        subquadratic=arch.subquadratic, frontend=arch.frontend,
        n_frontend_tokens=8,
    )
    if arch.family == "moe":
        kw.update(n_experts=4, top_k=2, d_ff=64)
    if arch.family == "zamba":
        kw.update(ssm_state=16, ssm_headdim=32, ssm_expand=2, zamba_group=2,
                  n_layers=5)
    if arch.family == "rwkv":
        kw.update(rwkv_headdim=32)
    if arch.family == "encdec":
        kw.update(n_decoder_layers=2)
    return ArchConfig(**kw)
