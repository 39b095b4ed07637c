"""Uniform model API (the port of the reference's ``models/registry.py``).

``get_model(cfg)`` returns a :class:`ModelAPI` with:
  - init(seed, device=None, master=False) -> params       [master: float32, training]
  - forward(params, batch, cfg) -> (logits, aux)          [inference]
  - train_forward(params, batch, cfg) -> (logits, aux)    [autograd, training]
  - init_decode_state(batch, capacity, device=None) -> state
  - decode(params, state, token) -> (logits, state)       [serve_step core; .slots under a mesh]
  - input_specs(shape) -> dict of TensorSpec              [dry-run stand-ins]
  - workload(shape) -> repro_torch.core.Workload          [planner integration]

As in the reference, the dense, MoE and VLM families go to
:mod:`.transformer` (the VLM forward reads ``batch["patch_embeds"]`` as its
prefix), ``ssm`` and ``hybrid`` to :mod:`.hybrid`, ``xlstm`` to
:mod:`.xlstm` and ``encdec`` to :mod:`.encdec` (its forward reads
``batch["frames"]``).  Each of those modules has its ``params_from_numpy``
(the reference's parameter tree, as numpy arrays, to the port's).
:func:`lm_workload` (layers as pipeline stages, analytic FLOPs) reads only
the config.  ``input_specs`` gives the dry run (:mod:`repro_torch.launch.dryrun`)
the inputs of a cell as :class:`TensorSpec` (the reference's
``jax.ShapeDtypeStruct`` stand-ins), and :func:`spec_tensors` makes ``meta``
tensors of them.  ``init(seed, device="meta")`` and
``init_decode_state(..., device="meta")`` build the trees as ``meta``
tensors of the shapes and dtypes a real init gives, drawing no numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..core.workload import Workload
from . import encdec, hybrid, transformer, xlstm
from .common import ModelConfig, ShapeSpec

__all__ = ["ModelAPI", "TensorSpec", "get_model", "layer_flops", "lm_workload", "spec_tensors",
           "stub_inputs"]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one input (``jax.ShapeDtypeStruct``'s
    counterpart)."""

    shape: tuple
    dtype: torch.dtype


def spec_tensors(specs: dict, device="meta") -> dict:
    """Uninitialized tensors of ``specs`` (name -> :class:`TensorSpec`) on
    ``device``: ``meta`` tensors by default, which hold no data."""
    return {k: torch.empty(s.shape, dtype=s.dtype, device=device) for k, s in specs.items()}


def _stub_input(cfg: ModelConfig) -> tuple:
    """(name, rows) of the stub frontend's input a family's forward reads
    besides its tokens, or (None, 0)."""
    return {"vlm": ("patch_embeds", cfg.n_vis_tokens),
            "encdec": ("frames", cfg.enc_seq)}.get(cfg.family, (None, 0))


def _input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """A cell's inputs, as the reference's ``_tok_specs`` and its families
    give them: tokens and labels (B, S) int32 for training, tokens for
    prefill, one token (B, 1) for decode; outside decode, the VLM's patch
    embeddings (B, n_vis_tokens, d) or the enc-dec model's frames (B,
    enc_seq, d) in the compute dtype."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        specs = {"tokens": TensorSpec((B, S), i32), "labels": TensorSpec((B, S), i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": TensorSpec((B, S), i32)}
    else:
        specs = {"token": TensorSpec((B, 1), i32)}
    name, rows = _stub_input(cfg)
    if name is not None and shape.kind != "decode":
        specs[name] = TensorSpec((B, rows, cfg.d_model), cfg.torch_dtype)
    return specs


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable               # (seed, device=None, master=False) -> params
    forward: Callable            # (params, batch, cfg) -> (logits, aux), inference
    train_forward: Callable      # (params, batch, cfg) -> (logits, aux), autograd
    init_decode_state: Callable  # (batch, capacity, device=None) -> state
    decode: Callable             # (params, state, token) -> (logits, state)
    input_specs: Callable        # (ShapeSpec) -> dict of TensorSpec
    workload: Callable           # (ShapeSpec) -> Workload


class _MetaGenerator(torch.Generator):
    """A generator that names the ``meta`` device: the init functions draw
    with ``device=gen.device``, and a draw on ``meta`` makes a tensor of its
    shape and dtype without drawing a number (this generator's state never
    moves)."""

    device = torch.device("meta")


def _init(module, cfg: ModelConfig, seed: int, device=None, master: bool = False) -> dict:
    dev = resolve_device(device)
    gen = _MetaGenerator() if dev.type == "meta" else torch.Generator(device=dev)
    gen.manual_seed(seed)
    return module.init_params(gen, cfg, master)


def _no_extras(batch: dict) -> dict:
    return {}


def stub_inputs(cfg: ModelConfig, batch: int, device, gen: torch.Generator = None) -> dict:
    """The stub frontends' inputs a family's forward reads besides its
    tokens: the VLM's patch embeddings (B, n_vis_tokens, d), the enc-dec
    model's frames (B, enc_seq, d); zeros (the reference's training loop),
    or ``normal * 0.02`` drawn from ``gen`` (its smoke tests)."""
    name, rows = _stub_input(cfg)
    if name is None:
        return {}
    shape = (batch, rows, cfg.d_model)
    if gen is None:
        return {name: torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}
    x = torch.randn(shape, generator=gen, device=device) * 0.02
    return {name: x.to(cfg.torch_dtype)}


# family -> (module, the forward's keyword arguments read from the batch)
_FAMILIES = {
    "dense": (transformer, _no_extras),
    "moe": (transformer, _no_extras),
    "vlm": (transformer, lambda batch: {"prefix_embeds": batch["patch_embeds"]}),
    "ssm": (hybrid, _no_extras),
    "hybrid": (hybrid, _no_extras),
    "xlstm": (xlstm, _no_extras),
    "encdec": (encdec, lambda batch: {"frames": batch["frames"]}),
}


def _always_independent(cfg: ModelConfig, rows: int, seq: int) -> bool:
    """A family whose data slots share no work in a forward (no MoE
    dispatch across them)."""
    return True


def _train_forward(module, extras) -> Callable:
    """The family's ``train_forward`` over a batch dict.  Its ``slots``
    attribute is the same over the mesh's grid
    (``module.train_forward_slots``), (views, batch_slots, cfg, n_data) ->
    (each data slot's logits over its model slots, each data slot's aux),
    the family's extras (a VLM's ``prefix_embeds``, the
    enc-dec model's ``frames``) passed per data slot under their names,
    ``views`` the weights' ``SlotViews`` (``module.slot_views``), and
    ``independent(cfg, rows, seq)`` says whether each data slot's part may
    run on its own; the mesh train step and the dry run call them."""
    def fn(params, batch, c):
        return module.train_forward(params, batch["tokens"], c, **extras(batch))

    def fn_slots(views, batch_slots, c, n_data=None):
        kw = [extras(b) for b in batch_slots]
        per_slot = {k: [x[k] for x in kw] for k in kw[0]}
        return module.train_forward_slots(views, [b["tokens"] for b in batch_slots], c,
                                          n_data=n_data, **per_slot)
    fn.slots = fn_slots
    fn.slot_views = module.slot_views
    fn.independent = getattr(module, "data_slots_independent", _always_independent)
    return fn


def _decode(module, cfg: ModelConfig) -> Callable:
    """The family's decode step.  Its ``slots`` attribute is the step over
    the mesh's grid (``module.decode_slots``), (views, state, token_slots,
    n_data) -> each data slot's logits over its model slots, the state placed by ``state_specs`` and
    updated in place, ``views`` the weights' ``SlotViews``
    (``module.slot_views``), and ``independent(state, rows)`` says whether
    each data slot's part may run on its own; the dry run calls them."""
    def fn(params, state, token):
        return module.decode_step(params, state, token, cfg)

    fn.slots = lambda views, state, token_slots, n_data=None: module.decode_slots(
        views, state, token_slots, cfg, n_data)
    fn.slot_views = module.slot_views
    fn.independent = lambda state, rows: module.decode_independent(cfg, state, rows)
    return fn


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown family {cfg.family}")
    module, extras = _FAMILIES[cfg.family]
    return ModelAPI(
        cfg=cfg,
        init=lambda seed, device=None, master=False: _init(module, cfg, seed, device, master),
        forward=lambda params, batch, c: module.forward(params, batch["tokens"], c,
                                                        **extras(batch)),
        train_forward=_train_forward(module, extras),
        init_decode_state=lambda b, cap, device=None: module.init_decode_state(
            cfg, b, cap, device),
        decode=_decode(module, cfg),
        input_specs=lambda shape: _input_specs(cfg, shape),
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
