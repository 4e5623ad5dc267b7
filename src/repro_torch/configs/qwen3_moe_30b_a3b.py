"""qwen3-moe-30b-a3b [moe]: 48L, d=2048, 32H GQA kv=4 (head_dim 64),
MoE 128 experts top-8 (expert ff=768), vocab=151936.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.configs.base import ArchConfig, GroupDef

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=768,
    vocab_size=151936,
    groups=(GroupDef(pattern=(("attn", "moe"),), repeats=48),),
    n_experts=128,
    moe_top_k=8,
    d_ff_expert=768,
    act="swiglu",
    tie_embeddings=False,
    sub_quadratic=False,
    source="hf:Qwen/Qwen3-30B-A3B",
)
