"""Optimizer of the port (the reference's ``repro.optim``): AdamW, the
warm-up cosine schedule, global-norm clipping and gradient compression, over
trees of tensors."""

from .adamw import AdamWState, adamw_init, adamw_state_from_numpy, adamw_update
from .schedule import cosine_schedule, linear_warmup_cosine
from .clip import global_norm, clip_by_global_norm
from .compression import (topk_compress, topk_decompress, int8_compress,
                          int8_decompress, ErrorFeedbackState, ef_init, ef_compress_update)

__all__ = ["AdamWState", "adamw_init", "adamw_state_from_numpy", "adamw_update",
           "cosine_schedule", "linear_warmup_cosine", "global_norm", "clip_by_global_norm",
           "topk_compress", "topk_decompress", "int8_compress", "int8_decompress",
           "ErrorFeedbackState", "ef_init", "ef_compress_update"]
