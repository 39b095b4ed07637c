"""xLSTM dimension helpers (the port's copy of the part of the reference's
``models/xlstm.py`` that the planner's workload extraction reads).  The
xLSTM family itself, its mLSTM and sLSTM blocks, is not ported yet
(ROADMAP.md Queue 1 item 4)."""

from __future__ import annotations

from .common import ModelConfig

__all__ = ["mlstm_dims"]


def mlstm_dims(cfg: ModelConfig) -> tuple:
    d_in = 2 * cfg.d_model
    H = cfg.n_heads
    P = d_in // H
    return d_in, H, P
