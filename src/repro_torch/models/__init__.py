"""Model zoo of the port: every family of the reference (dense, MoE and VLM
decoder-only LMs, the Mamba2 hybrid, xLSTM, the enc-dec backbone), with the
planner's workload extraction and the training step."""

from .common import SHAPES, ModelConfig, ShapeSpec, active_param_count, param_count
from .registry import ModelAPI, get_model, layer_flops, lm_workload, stub_inputs
from .train import cross_entropy, init_optimizer, make_loss_fn, make_train_step
from .sharding import batch_spec, named, param_specs, zero1_specs

__all__ = ["SHAPES", "ModelAPI", "ModelConfig", "ShapeSpec", "active_param_count",
           "cross_entropy", "get_model", "init_optimizer", "layer_flops", "lm_workload",
           "make_loss_fn", "make_train_step", "param_count", "stub_inputs",
           "param_specs", "zero1_specs", "batch_spec", "named"]
