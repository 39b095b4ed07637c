"""The ten assigned architectures, as the port's own copies of the reference's
config modules (pure data).

``get_config(arch_id)`` / ``get_smoke_config(arch_id)`` return ModelConfigs
for every arch id, and :func:`repro_torch.models.get_model` builds each of
them.
"""

from __future__ import annotations

from ..models.common import SHAPES, ModelConfig, ShapeSpec
from . import (arctic_480b, internvl2_26b, mixtral_8x7b, qwen15_110b,
               qwen25_14b, qwen3_4b, stablelm_12b, whisper_large_v3,
               xlstm_350m, zamba2_7b)

__all__ = ["ARCH_IDS", "LONG_CONTEXT_OK", "SHAPES", "ModelConfig", "ShapeSpec",
           "cells", "get_config", "get_smoke_config", "supports"]

_MODULES = {
    "zamba2-7b": zamba2_7b,
    "qwen2.5-14b": qwen25_14b,
    "qwen3-4b": qwen3_4b,
    "qwen1.5-110b": qwen15_110b,
    "stablelm-12b": stablelm_12b,
    "arctic-480b": arctic_480b,
    "mixtral-8x7b": mixtral_8x7b,
    "xlstm-350m": xlstm_350m,
    "internvl2-26b": internvl2_26b,
    "whisper-large-v3": whisper_large_v3,
}

ARCH_IDS = tuple(_MODULES)

# Archs with sub-quadratic attention state growth (eligible for long_500k):
# hybrid (SSM + bounded attn), xlstm (recurrent), mixtral (sliding window).
LONG_CONTEXT_OK = {"zamba2-7b", "xlstm-350m", "mixtral-8x7b"}


def get_config(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].full()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].smoke()


def supports(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in LONG_CONTEXT_OK
    return True


def cells(include_skipped: bool = False):
    """Yield (arch_id, ShapeSpec[, skipped]) for the assigned 10x4 grid."""
    for a in ARCH_IDS:
        for sname, sspec in SHAPES.items():
            ok = supports(a, sname)
            if include_skipped:
                yield a, sspec, not ok
            elif ok:
                yield a, sspec
