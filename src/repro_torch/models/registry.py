"""Uniform model API (the port of the reference's ``models/registry.py``).

``get_model(cfg)`` returns a :class:`ModelAPI` with:
  - init(seed, device=None, master=False) -> params       [master: float32, training]
  - forward(params, batch, cfg) -> (logits, aux)          [inference]
  - train_forward(params, batch, cfg) -> (logits, aux)    [autograd, training]
  - init_decode_state(batch, capacity, device=None) -> state
  - decode(params, state, token) -> (logits, state)       [serve_step core]
  - workload(shape) -> repro_torch.core.Workload          [planner integration]

The dense family goes to :mod:`.transformer`, the ``ssm`` and ``hybrid``
families to :mod:`.hybrid` (as in the reference); the others are not ported
yet and raise ``NotImplementedError``.  :func:`lm_workload` (layers as
pipeline stages, analytic FLOPs) covers all ten architectures: it reads only
the config.  The reference's ``input_specs`` (``jax.ShapeDtypeStruct``
stand-ins for its dry run) waits for the dry run's port (ROADMAP.md Queue 1
item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..core.workload import Workload
from . import hybrid, transformer
from .common import ModelConfig, ShapeSpec

__all__ = ["ModelAPI", "get_model", "layer_flops", "lm_workload"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable               # (seed, device=None, master=False) -> params
    forward: Callable            # (params, batch, cfg) -> (logits, aux), inference
    train_forward: Callable      # (params, batch, cfg) -> (logits, aux), autograd
    init_decode_state: Callable  # (batch, capacity, device=None) -> state
    decode: Callable             # (params, state, token) -> (logits, state)
    workload: Callable           # (ShapeSpec) -> Workload


def _init(module, cfg: ModelConfig, seed: int, device=None, master: bool = False) -> dict:
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return module.init_params(gen, cfg, master)


_MODULES = {"dense": transformer, "ssm": hybrid, "hybrid": hybrid}


def get_model(cfg: ModelConfig) -> ModelAPI:
    module = _MODULES.get(cfg.family)
    if module is None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: {', '.join(sorted(_MODULES))}); "
            "see ROADMAP.md Queue 1")
    return ModelAPI(
        cfg=cfg,
        init=lambda seed, device=None, master=False: _init(module, cfg, seed, device, master),
        forward=lambda params, batch, c: module.forward(params, batch["tokens"], c),
        train_forward=lambda params, batch, c: module.train_forward(params, batch["tokens"],
                                                                    c),
        init_decode_state=lambda b, cap, device=None: module.init_decode_state(
            cfg, b, cap, device),
        decode=lambda p, st, tok: module.decode_step(p, st, tok, cfg),
        workload=lambda shape: lm_workload(cfg, shape),
    )


# ---------------------------------------------------------------------------
# Workload extraction (planner integration): layers as pipeline stages
# ---------------------------------------------------------------------------

def layer_flops(cfg: ModelConfig, seq: int, batch: int) -> float:
    """Analytic forward FLOPs of one block at (batch, seq)."""
    d, hd = cfg.d_model, cfg.head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    T = batch * seq
    qkvo = 2 * T * d * (H * hd + 2 * K * hd + H * hd)
    if cfg.sliding_window:
        eff = min(seq, cfg.sliding_window)
        attn = 2 * T * eff * hd * H * 2 / 2
    else:
        attn = 2 * T * seq * hd * H * 2 / 2          # causal: half the square
    if cfg.family == "moe":
        ffn = 2 * T * cfg.top_k * 3 * d * cfg.expert_d_ff
        if cfg.dense_residual:
            ffn += 2 * T * 3 * d * cfg.d_ff
    elif cfg.family in ("ssm", "hybrid"):
        from .ssm import ssm_dims

        d_in, Hm, P, N = ssm_dims(cfg)
        ffn = 2 * T * d * (2 * d_in + 2 * N + Hm) + 2 * T * d_in * d \
            + 2 * T * d_in * N * 2                    # in/out proj + state update/read
        qkvo, attn = 0.0, 0.0                         # attention only in shared block
    elif cfg.family == "xlstm":
        from .xlstm import mlstm_dims

        d_in, Hm, P = mlstm_dims(cfg)
        ffn = 2 * T * d * 2 * d_in + 3 * 2 * T * d_in * d_in + 2 * T * d_in * d
        qkvo, attn = 0.0, 0.0
    else:
        mult = 3 if cfg.act == "swiglu" else 2
        ffn = 2 * T * mult * d * cfg.d_ff
    return float(qkvo + attn + ffn)


def _attn_block_flops(cfg: ModelConfig, seq: int, batch: int) -> float:
    d, hd, H, K = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    T = batch * seq
    mlp_f = 2 * T * (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
    return float(2 * T * d * (2 * H * hd + 2 * K * hd) + 2 * T * seq * hd * H + mlp_f)


def lm_workload(cfg: ModelConfig, shape: ShapeSpec) -> Workload:
    """Layers (blocks) as pipeline stages; delta = inter-layer activation bytes."""
    seq = shape.seq_len if shape.kind != "decode" else 1
    B = shape.global_batch
    act_bytes = B * seq * cfg.d_model * 2.0           # bf16 activations
    if cfg.family == "encdec":
        # decode reuses precomputed cross K/V: the encoder contributes nothing
        enc_w = 0.0 if shape.kind == "decode" else layer_flops(cfg, cfg.enc_seq, B) * 0.75
        w = [enc_w] * cfg.n_enc_layers + \
            [layer_flops(cfg, seq, B)] * cfg.n_layers
        delta = [B * cfg.enc_seq * cfg.d_model * 2.0] * (cfg.n_enc_layers + 1) + \
                [act_bytes] * cfg.n_layers
        return Workload(np.array(w), np.array(delta), name=cfg.arch_id)
    w = np.full(cfg.n_layers, layer_flops(cfg, seq, B))
    if cfg.family == "hybrid" and cfg.attn_every:
        w = w.copy()
        for i in range(0, cfg.n_layers, cfg.attn_every):
            w[i] += _attn_block_flops(cfg, seq, B)
    delta = np.full(cfg.n_layers + 1, act_bytes)
    return Workload(w, delta, name=cfg.arch_id)
