"""Paper simulation study (Section 5) of the port: the scenario-family
registry (own copy of the reference's generators), the campaign runner on a
torch device (batched and scalar engines), Table 1 and the replication
sweeps."""

from .generators import (EXPERIMENTS, FAMILY_SETS, IMAGE_FAMILIES,
                         PAPER_FAMILIES, RELIABILITY_FAMILIES, ExperimentSpec,
                         InstanceBatch, gen_instance, gen_instance_batch,
                         register_experiment)
from .experiments import (ExperimentResult, ReplicatedResult,
                          failure_thresholds, run_campaign, run_experiment,
                          run_replicated, summarize_experiment,
                          summarize_replicated, trajectory)

__all__ = ["EXPERIMENTS", "FAMILY_SETS", "PAPER_FAMILIES", "IMAGE_FAMILIES",
           "RELIABILITY_FAMILIES", "ExperimentSpec", "register_experiment",
           "InstanceBatch", "gen_instance", "gen_instance_batch",
           "ExperimentResult", "ReplicatedResult", "failure_thresholds",
           "run_campaign", "run_experiment", "run_replicated",
           "summarize_experiment", "summarize_replicated", "trajectory"]
