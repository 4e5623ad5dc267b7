"""qwen1.5-32b [dense]: 64L, d=5120, 40H (kv=40, MHA), ff=27392, QKV bias,
vocab=152064.  [hf:Qwen/Qwen1.5-32B; hf]"""

from repro_torch.configs.base import ArchConfig, uniform_groups

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    groups=uniform_groups(64),
    qkv_bias=True,
    act="swiglu",
    tie_embeddings=False,
    sub_quadratic=False,
    source="hf:Qwen/Qwen1.5-32B",
)
