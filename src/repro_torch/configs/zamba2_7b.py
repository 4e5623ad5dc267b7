"""zamba2-7b [hybrid]: 81 Mamba2 layers (d=3584, d_state=64) with ONE
shared-weight attention+MLP block (32H over concat width 2d=7168, head_dim
224, ff=14336) applied every 6 layers (13 applications), Zamba-style.
Organised as 13 scanned groups of (shared-attn -> 6 mamba) + 3 trailing
mamba layers.  [arXiv:2411.15242; unverified]"""

from repro_torch.configs.base import ArchConfig, GroupDef

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,  # informational; the shared block uses shared_head_dim=224
    d_ff=14336,
    vocab_size=32000,
    groups=(
        GroupDef(pattern=(("mamba", None),) * 6, repeats=13, shared_prefix=True),
        GroupDef(pattern=(("mamba", None),) * 3, repeats=1),
    ),
    ssm_state=64,
    ssm_headdim=64,
    ssm_chunk=256,
    ssm_conv=4,
    ssm_expand=2,
    shared_block=True,
    act="geglu",
    tie_embeddings=True,
    sub_quadratic=True,  # Mamba state + 13 shared-attn caches
    source="arXiv:2411.15242",
)
