"""whisper-medium [audio]: enc-dec, 24L(+24 enc), d=1024, 16H MHA, ff=4096,
vocab=51865.  Conv audio frontend is a stub — input_specs feeds precomputed
frame embeddings.  [arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import ArchConfig, uniform_groups

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    groups=uniform_groups(24),
    n_enc_layers=24,
    act="gelu",
    use_rope=False,  # Whisper: sinusoidal positions
    tie_embeddings=True,
    sub_quadratic=False,  # full attention -> long_500k skipped (DESIGN §4)
    source="arXiv:2212.04356",
)
