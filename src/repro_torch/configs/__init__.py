"""AIDW workload configurations."""

from repro_torch.configs.aidw import AIDW_WORKLOADS, PAPER_SIZES, AIDWWorkload

__all__ = ["AIDW_WORKLOADS", "PAPER_SIZES", "AIDWWorkload"]
