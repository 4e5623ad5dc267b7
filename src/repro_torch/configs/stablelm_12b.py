"""stablelm-12b [dense]: 40L, d=5120, 32H GQA kv=8 (head_dim 160), ff=13824,
vocab=100352.  [hf:stabilityai/stablelm-2-12b; hf]"""

from repro_torch.configs.base import ArchConfig, uniform_groups

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    groups=uniform_groups(40),
    act="swiglu",
    tie_embeddings=False,
    sub_quadratic=False,
    source="hf:stabilityai/stablelm-2-12b",
)
