"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions.

The kernels are built at first use (``_build``), never at import."""

from repro_torch.kernels.ops import aidw, idw

__all__ = ["aidw", "idw"]
