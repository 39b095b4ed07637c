"""Hand-written CUDA kernels of the port (built from ``csrc/`` at first use),
their PyTorch wrappers, the model kernels' public wrappers (:mod:`.ops`) and
their plain oracles (:mod:`.ref`)."""

from . import ops, ref
from .split_score import pair_need, score_2way_cuda, score_3way_cuda

__all__ = ["ops", "pair_need", "ref", "score_2way_cuda", "score_3way_cuda"]
