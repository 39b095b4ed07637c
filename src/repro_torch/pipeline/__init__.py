"""Pipeline-parallel runtime driven by the paper's interval planner: the
GPipe schedule, the runtime that runs a planner ``StagePlan`` as a pipeline
(:mod:`.runtime`), and online re-planning (the port of ``repro.pipeline``)."""

from .schedule import bubble_fraction, gpipe_ticks, stage_microbatch
from .runtime import (PipelineSpec, make_stage_params, pipelined_loss_fn,
                      sequential_loss_fn)
from .replan import (StragglerMonitor, elastic_platform, elastic_replan,
                     replan_stages)

__all__ = ["gpipe_ticks", "stage_microbatch", "bubble_fraction",
           "PipelineSpec", "make_stage_params", "pipelined_loss_fn",
           "sequential_loss_fn", "StragglerMonitor", "replan_stages",
           "elastic_platform", "elastic_replan"]
