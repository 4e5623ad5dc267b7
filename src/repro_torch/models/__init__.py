"""The LM scaffold's models (``repro.models``' counterpart): parameter
specs, layers, attention, MoE, blocks and the decoder LM."""

from repro_torch.models.registry import build_model

__all__ = ["build_model"]
