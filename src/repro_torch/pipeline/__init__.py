"""Pipeline schedules and online re-planning of the port (the pipeline
runtime, ``repro.pipeline.runtime``, is not ported yet)."""

from .schedule import bubble_fraction, gpipe_ticks, stage_microbatch
from .replan import (StragglerMonitor, elastic_platform, elastic_replan,
                     replan_stages)

__all__ = ["gpipe_ticks", "stage_microbatch", "bubble_fraction",
           "StragglerMonitor", "replan_stages", "elastic_platform",
           "elastic_replan"]
