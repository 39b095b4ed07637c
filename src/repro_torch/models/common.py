"""Shared model configuration covering all ten assigned architectures (the
port's own copy of the reference's ``models/common.py``: the same fields, names
and defaults, with torch dtypes in place of JAX's), and the ambient mesh
(:func:`abstract_mesh`), which ``repro_torch.launch.mesh.use_mesh`` sets."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# the ambient mesh, the data slot being computed, and whether the data slots
# may be taken as symmetric, set by ``repro_torch.launch.mesh.use_mesh`` /
# ``data_slot_scope`` / ``symmetric_data_slots``
_AMBIENT = {"mesh": None, "data_slot": 0, "symmetric": False}


def abstract_mesh():
    """The mesh of the innermost ``use_mesh`` block (the reference's
    ``jax.sharding.get_abstract_mesh()``); ``None`` outside any, where every
    call site keeps its single-device path."""
    return _AMBIENT["mesh"]


def data_slot() -> int:
    """The data slot (row-major over the mesh's ``pod`` and ``data`` axes)
    whose rows the model code is computing (its ``model`` slots compute
    them, tensor-parallel)."""
    return _AMBIENT["data_slot"]


def symmetric_data() -> bool:
    """Whether a step may compute one data slot for all of them
    (:func:`repro_torch.launch.mesh.symmetric_data_slots`)."""
    return _AMBIENT["symmetric"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | xlstm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # SWA window (mixtral)
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "swiglu"              # swiglu | gelu

    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    dense_residual: bool = False     # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    moe_shard_map: bool = True       # manual-data dispatch (False: pure GSPMD —
                                     # needed for bf16 params on XLA:CPU, see moe.py)
    fsdp_params: bool = False        # 2D weight sharding (model x data), per-layer gather

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2): shared full-attention block applied every k layers
    attn_every: int = 0

    # xlstm: every k-th block is an sLSTM block (others mLSTM)
    slstm_every: int = 0
    xlstm_chunk: int = 256

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500              # 30 s of audio frames (stub frontend)

    # vlm (internvl2)
    n_vis_tokens: int = 0            # stub ViT frontend output length

    # numerics / execution
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "block"             # none | block  (checkpoint each scanned block)
    accum_steps: int = 1             # gradient-accumulation microbatches per step
    use_pallas: bool = False         # use Pallas kernels for hot paths
    attn_chunk: int = 1024           # KV block for chunked attention
    scan_layers: bool = True

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (matches init to within ties/rounding)."""
    d, h, kv, hd, ff, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.n_layers)
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    mlp = 3 * d * ff if cfg.act == "swiglu" else 2 * d * ff
    if cfg.family == "moe":
        moe = cfg.n_experts * 3 * d * cfg.expert_d_ff + d * cfg.n_experts
        mlp = moe + (3 * d * cfg.d_ff if cfg.dense_residual else 0)
    per_layer = attn + mlp + 2 * d
    if cfg.family == "ssm":
        per_layer = _mamba2_params(cfg) + 2 * d
    if cfg.family == "hybrid":
        per_layer = _mamba2_params(cfg) + 2 * d
        emb += attn + 2 * d          # one shared attention block
    if cfg.family == "xlstm":
        # rough: mLSTM blocks dominate
        per_layer = _mlstm_params(cfg) + 2 * d
    if cfg.family == "encdec":
        dec = attn + attn + mlp + 3 * d          # self + cross + mlp
        enc = attn + mlp + 2 * d
        return emb + cfg.n_enc_layers * enc + L * dec
    return emb + L * per_layer


def _mamba2_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    G = 1
    proj_in = d * (2 * d_in + 2 * G * cfg.ssm_state + H)
    conv = (d_in + 2 * G * cfg.ssm_state) * cfg.ssm_conv
    return proj_in + conv + H + H + d_in + d_in * d  # A, D, norm-ish, out


def _mlstm_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_in = 2 * d
    return d * 2 * d_in + 3 * d_in * d_in // 1 + d_in * d  # rough


def active_param_count(cfg: ModelConfig) -> int:
    """Active (per-token) parameters: MoE counts only top-k experts."""
    if cfg.family != "moe":
        return param_count(cfg)
    d, ff, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    moe_active = cfg.top_k * 3 * d * cfg.expert_d_ff + d * cfg.n_experts
    dense = 3 * d * cfg.d_ff if cfg.dense_residual else 0
    return emb + L * (attn + moe_active + dense + 2 * d)
