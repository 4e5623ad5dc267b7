"""Model construction from ``ArchConfig``.  Counterpart of
``repro.models.registry``."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import SSM_SLICE
from repro_torch.models.lm import DecoderLM


def build_model(cfg: ArchConfig) -> DecoderLM:
    """The model of ``cfg``.  The audio family (``EncDecLM``) and archs with
    a Mamba layer or a shared block are not ported yet: they raise
    ``NotImplementedError`` before anything is built."""
    if cfg.family == "audio":
        raise NotImplementedError("the encoder-decoder (EncDecLM) is ported in ROADMAP.md A10 slice 1b")
    if cfg.shared_block or any(mixer == "mamba" for g in cfg.groups for mixer, _ in g.pattern):
        raise NotImplementedError(SSM_SLICE)
    return DecoderLM(cfg)
