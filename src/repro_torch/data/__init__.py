"""Data pipeline of the port (the reference's ``repro.data``)."""

from .pipeline import ShardedLoader, SyntheticLMDataset

__all__ = ["ShardedLoader", "SyntheticLMDataset"]
