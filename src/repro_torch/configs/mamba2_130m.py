"""mamba2-130m [ssm]: 24L, d=768, attention-free SSD, d_state=128,
vocab=50280.  [arXiv:2405.21060; unverified]"""

from repro_torch.configs.base import ArchConfig, uniform_groups

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    groups=uniform_groups(24, mixer="mamba", ff=None),
    ssm_state=128,
    ssm_headdim=64,
    ssm_chunk=256,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=True,
    sub_quadratic=True,  # O(1) decode state
    source="arXiv:2405.21060",
)
