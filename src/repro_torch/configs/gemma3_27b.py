"""gemma3-27b [dense]: 62L as 10x(5 local + 1 global) + 2 local, d=5376,
32H GQA kv=16, head_dim 128 (deployed size; 5376/32=168 is not used by the
real model), ff=21504, vocab=262144, sliding window 1024, GeGLU.
5:1 local:global + 128k context.  [hf:google/gemma-3-27b-pt; unverified]"""

from repro_torch.configs.base import ArchConfig, GroupDef

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    groups=(
        GroupDef(pattern=(("local", "dense"),) * 5 + (("attn", "dense"),), repeats=10),
        GroupDef(pattern=(("local", "dense"),) * 2, repeats=1),
    ),
    act="geglu",
    rope_theta=1_000_000.0,
    sliding_window=1024,
    windowed_cache=True,  # §Perf E: ring-buffer decode caches for local layers
    tie_embeddings=True,
    # 5:1 local:global: decode reads are window-bounded on locals; eligible
    # for long_500k (globals are linear-in-S decode reads, not quadratic).
    sub_quadratic=True,
    source="arXiv:2503.19786",
)
