"""The paper's own experimental configurations (Section 5.1) as framework
configs, plus TPU-cluster planner presets (the port's copy of the
reference's ``configs/paper_pipeline.py``)."""

from __future__ import annotations

from ..core import Platform, tpu_pod_platform
from ..sim.generators import gen_instance

__all__ = ["paper_instance", "tpu_many_pod_platform", "tpu_two_pod_platform"]


def paper_instance(exp: str = "E1", n: int = 20, p: int = 10, seed: int = 0):
    """One of the paper's random (workload, platform) pairs."""
    return gen_instance(exp, n, p, seed)


def tpu_two_pod_platform(straggler: dict | None = None) -> Platform:
    """The reference's dry-run target: 2 pods x 256 chips, DCN-linked."""
    return tpu_pod_platform(pods=2, chips_per_pod=256, degraded=straggler)


def tpu_many_pod_platform(pods: int = 8, straggler: dict | None = None) -> Platform:
    """The reference's scale-out preset (8 pods x 256 = 2048 chips)."""
    return tpu_pod_platform(pods=pods, chips_per_pod=256, degraded=straggler)
