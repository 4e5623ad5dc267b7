"""mixtral-8x7b [moe]: 32L, d=4096, 32H GQA kv=8, MoE 8 experts top-2
(expert ff=14336), SWA 4096, vocab=32000.  [arXiv:2401.04088; hf]"""

from repro_torch.configs.base import ArchConfig, GroupDef

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    groups=(GroupDef(pattern=(("local", "moe"),), repeats=32),),
    sliding_window=4096,
    windowed_cache=True,  # §Perf E: ring-buffer decode caches for local layers
    n_experts=8,
    moe_top_k=2,
    d_ff_expert=14336,
    act="swiglu",
    tie_embeddings=False,
    sub_quadratic=True,  # sliding-window attention -> bounded decode cache
    source="arXiv:2401.04088",
)
