"""The port's counterparts of the reference's ``examples/``: each runs as
``python -m repro_torch.examples.<name> [--device cpu]`` (the card by
default), prints what the reference's example prints and keeps its
asserts.

- :mod:`.quickstart`: the paper's bi-criteria mapping end to end (the
  heuristics, the request/report protocol, the Pareto front, the deal
  extension).
- :mod:`.replan_straggler`: a pod slows down mid-training; the monitor sees
  it and the planner re-balances the intervals.
- :mod:`.serve_batched`: continuous-batching decode over a request pool.
- :mod:`.train_pipeline`: a smoke-size model trained on the synthetic
  stream with checkpoints.
"""
