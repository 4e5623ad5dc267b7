"""Architecture registry (the 10 assigned archs, counterpart of
``repro.configs``) and the AIDW workload configurations."""

from repro_torch.configs.aidw import AIDW_WORKLOADS, PAPER_SIZES, AIDWWorkload
from repro_torch.configs.base import SHAPES, ArchConfig, GroupDef, ShapeConfig, smoke

from repro_torch.configs import (  # noqa: E402
    gemma3_27b,
    mamba2_130m,
    minitron_4b,
    mixtral_8x7b,
    qwen1_5_32b,
    qwen2_vl_72b,
    qwen3_moe_30b_a3b,
    stablelm_12b,
    whisper_medium,
    zamba2_7b,
)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        whisper_medium,
        minitron_4b,
        stablelm_12b,
        gemma3_27b,
        qwen1_5_32b,
        mamba2_130m,
        mixtral_8x7b,
        qwen3_moe_30b_a3b,
        qwen2_vl_72b,
        zamba2_7b,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def cell_is_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The 40-cell applicability matrix (DESIGN.md §4)."""
    if shape.kind == "long" and not arch.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (needs sub-quadratic attention)"
    return True, ""


__all__ = [
    "AIDW_WORKLOADS",
    "PAPER_SIZES",
    "AIDWWorkload",
    "ARCHS",
    "SHAPES",
    "ArchConfig",
    "GroupDef",
    "ShapeConfig",
    "smoke",
    "get_arch",
    "get_shape",
    "cell_is_applicable",
]
