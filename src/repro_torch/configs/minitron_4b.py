"""minitron-4b [dense]: 32L, d=3072, 24H GQA kv=8, ff=9216, vocab=256000
(pruned nemotron).  [arXiv:2407.14679; hf]"""

from repro_torch.configs.base import ArchConfig, uniform_groups

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    groups=uniform_groups(32),
    act="swiglu",
    tie_embeddings=False,
    sub_quadratic=False,
    source="arXiv:2407.14679",
)
