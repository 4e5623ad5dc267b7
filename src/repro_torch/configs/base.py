"""Config schema: architectures (the assigned pool) and input shapes.
Counterpart of ``repro.configs.base``, copied field for field."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class GroupDef:
    """A scanned stack of identical layer groups.

    pattern: per-layer (mixer, ff) kinds within one group;
      mixer in {"attn" (full causal), "local" (sliding window), "mamba",
                "bidir" (encoder)}; ff in {"dense", "moe", None}.
    repeats: scan length (number of groups).
    shared_prefix: apply the arch's shared attention block (Zamba-style)
      before each repeat of this group.
    """

    pattern: tuple
    repeats: int
    shared_prefix: bool = False


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio (enc-dec)
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    groups: tuple  # tuple[GroupDef, ...] — the decoder stack
    n_enc_layers: int = 0  # encoder stack (enc-dec archs)
    qkv_bias: bool = False
    act: str = "swiglu"
    rope_theta: float = 10000.0
    use_rope: bool = True
    sliding_window: int | None = None
    mrope_sections: tuple | None = None
    n_vis_tokens: int = 0
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    moe_capacity_factor: float = 1.25  # GShard-style; tokens above capacity drop
    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_expand: int = 2
    # hybrid
    shared_block: bool = False
    # decode: window-sized ring-buffer caches for sliding-window layers
    windowed_cache: bool = False
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # capabilities
    sub_quadratic: bool = False  # eligible for long_500k (decode-state bounded)
    source: str = ""

    @property
    def n_layers(self) -> int:
        return sum(len(g.pattern) * g.repeats for g in self.groups)

    @property
    def shared_d(self) -> int:
        return 2 * self.d_model  # Zamba-style shared block width

    @property
    def shared_head_dim(self) -> int:
        return self.shared_d // self.n_heads


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    kind: str  # train | prefill | decode | long (long lowers serve_step too)
    seq_len: int
    global_batch: int
    accum_steps: int = 1  # gradient-accumulation microbatches (train only)

    @property
    def step(self) -> str:
        return {"train": "train_step", "prefill": "prefill_step"}.get(self.kind, "serve_step")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256, accum_steps=8),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "long", 524288, 1),
}


def uniform_groups(n_layers: int, mixer: str = "attn", ff: str | None = "dense"):
    return (GroupDef(pattern=((mixer, ff),), repeats=n_layers),)


def smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (small widths, few
    layers/experts/states, tiny vocab) — shape-generic across the pool."""
    groups = tuple(
        dataclasses.replace(g, repeats=min(g.repeats, 2)) for g in cfg.groups
    )
    head_dim = 16
    return dataclasses.replace(
        cfg,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads >= cfg.n_heads else 2,
        head_dim=head_dim,
        d_ff=128,
        vocab_size=256,
        groups=groups,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        sliding_window=8 if cfg.sliding_window else None,
        mrope_sections=(4, 2, 2) if cfg.mrope_sections else None,
        n_vis_tokens=8 if cfg.n_vis_tokens else 0,
        n_experts=min(cfg.n_experts, 8),
        moe_top_k=min(cfg.moe_top_k, 2),
        d_ff_expert=32 if cfg.d_ff_expert else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=8,
        ssm_chunk=16,
    )
