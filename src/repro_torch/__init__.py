"""PyTorch/CUDA port of the multi-criteria pipeline-mapping planner.

A second package beside the JAX reference ``repro``: it imports torch and
numpy only, keeps its own copies of the host-side modules it needs, and runs
the Section-5 campaign's lockstep engine on a CUDA device, with the
split-scoring kernels written by hand in CUDA C++ for Hopper
(:mod:`repro_torch.kernels`).

Device rule: every public entry point takes ``device=None``, which means
``cuda``.  Without a CUDA device that raises ``RuntimeError``: nothing runs on
the CPU unless the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA, and a CUDA
    request on a host without a CUDA device raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the host")
    return dev
