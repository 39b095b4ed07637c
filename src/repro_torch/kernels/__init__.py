"""Hand-written CUDA kernels of the port (built from ``csrc/`` at first use)
and their PyTorch wrappers."""

from .split_score import pair_need, score_2way_cuda, score_3way_cuda

__all__ = ["pair_need", "score_2way_cuda", "score_3way_cuda"]
