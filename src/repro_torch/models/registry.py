"""Uniform model API (the port of the reference's ``models/registry.py``).

``get_model(cfg)`` returns a :class:`ModelAPI` with:
  - init(seed, device=None) -> params
  - forward(params, batch, cfg) -> (logits, aux)          [train / prefill]
  - init_decode_state(batch, capacity, device=None) -> state
  - decode(params, state, token) -> (logits, state)       [serve_step core]

The dense family goes to :mod:`.transformer`, the ``ssm`` and ``hybrid``
families to :mod:`.hybrid` (as in the reference); the others are not ported
yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import resolve_device
from . import hybrid, transformer
from .common import ModelConfig

__all__ = ["ModelAPI", "get_model"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable               # (seed, device=None) -> params
    forward: Callable            # (params, batch, cfg) -> (logits, aux)
    init_decode_state: Callable  # (batch, capacity, device=None) -> state
    decode: Callable             # (params, state, token) -> (logits, state)


def _init(module, cfg: ModelConfig, seed: int, device=None) -> dict:
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return module.init_params(gen, cfg)


_MODULES = {"dense": transformer, "ssm": hybrid, "hybrid": hybrid}


def get_model(cfg: ModelConfig) -> ModelAPI:
    module = _MODULES.get(cfg.family)
    if module is None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: {', '.join(sorted(_MODULES))}); "
            "see ROADMAP.md Queue 1")
    return ModelAPI(
        cfg=cfg,
        init=lambda seed, device=None: _init(module, cfg, seed, device),
        forward=lambda params, batch, c: module.forward(params, batch["tokens"], c),
        init_decode_state=lambda b, cap, device=None: module.init_decode_state(
            cfg, b, cap, device),
        decode=lambda p, st, tok: module.decode_step(p, st, tok, cfg),
    )
