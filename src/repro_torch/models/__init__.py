"""Model zoo of the port: the dense decoder-only LM and the Mamba2 hybrid so far."""

from .common import SHAPES, ModelConfig, ShapeSpec, active_param_count, param_count
from .registry import ModelAPI, get_model

__all__ = ["SHAPES", "ModelAPI", "ModelConfig", "ShapeSpec", "active_param_count",
           "get_model", "param_count"]
