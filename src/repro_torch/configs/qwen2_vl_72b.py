"""qwen2-vl-72b [vlm]: 80L, d=8192, 64H GQA kv=8, ff=29568, vocab=152064,
M-RoPE (t/h/w sections 16/24/24 of head_dim/2), dynamic resolution.
Vision frontend is a STUB per the assignment — input_specs feeds precomputed
patch embeddings merged ahead of the text tokens, and M-RoPE position ids.
[arXiv:2409.12191; hf]"""

from repro_torch.configs.base import ArchConfig, uniform_groups

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    groups=uniform_groups(80),
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    n_vis_tokens=256,
    act="swiglu",
    tie_embeddings=False,
    sub_quadratic=False,
    source="arXiv:2409.12191",
)
