"""AIDW workload configurations: the paper's sizes (section 4: 10K..1000K
points, data count == query count, unit square) and the production sizes
of the JAX package's ``repro.configs.aidw``."""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.aidw import AIDWParams


@dataclass(frozen=True)
class AIDWWorkload:
    name: str
    m: int  # data points
    n: int  # interpolated points
    k: int = 10
    mode: str = "ring"  # "ring" (data sharded) | "replicated" (queries only)
    q_chunk: int = 1024
    d_chunk: int = 2048

    @property
    def params(self) -> AIDWParams:
        return AIDWParams(k=self.k, area=1.0)


# the paper's Table-1 sizes (1K = 1024)
PAPER_SIZES = {f"{s}K": s * 1024 for s in (10, 50, 100, 500, 1000)}

AIDW_WORKLOADS = {
    # paper scale: one card holds it, queries split, data replicated
    "aidw-pod-1m": AIDWWorkload("aidw-pod-1m", m=1 << 20, n=1 << 20, mode="replicated"),
    # production scale: the data must be ring-sharded across devices
    "aidw-ring-134m": AIDWWorkload("aidw-ring-134m", m=1 << 27, n=1 << 24, mode="ring"),
    # the same workload with queries and state rotating instead of data
    "aidw-ringq-134m": AIDWWorkload("aidw-ringq-134m", m=1 << 27, n=1 << 24, mode="ring_q"),
}
