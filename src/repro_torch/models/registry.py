"""Uniform model API (the port of the reference's ``models/registry.py``).

``get_model(cfg)`` returns a :class:`ModelAPI` with:
  - init(seed, device=None) -> params
  - forward(params, batch, cfg) -> (logits, aux)          [train / prefill]
  - init_decode_state(batch, capacity, device=None) -> state
  - decode(params, state, token) -> (logits, state)       [serve_step core]

Only the dense family is ported; the others raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import resolve_device
from . import transformer
from .common import ModelConfig

__all__ = ["ModelAPI", "get_model"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable               # (seed, device=None) -> params
    forward: Callable            # (params, batch, cfg) -> (logits, aux)
    init_decode_state: Callable  # (batch, capacity, device=None) -> state
    decode: Callable             # (params, state, token) -> (logits, state)


def _init(cfg: ModelConfig, seed: int, device=None) -> dict:
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return transformer.init_params(gen, cfg)


def get_model(cfg: ModelConfig) -> ModelAPI:
    transformer.check_family(cfg)
    return ModelAPI(
        cfg=cfg,
        init=lambda seed, device=None: _init(cfg, seed, device),
        forward=lambda params, batch, c: transformer.forward(params, batch["tokens"], c),
        init_decode_state=lambda b, cap, device=None: transformer.init_decode_state(
            cfg, b, cap, device),
        decode=lambda p, st, tok: transformer.decode_step(p, st, tok, cfg),
    )
