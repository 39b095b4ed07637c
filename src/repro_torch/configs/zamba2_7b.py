"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]"""

from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
        attn_every=6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-7b-smoke", family="hybrid",
        n_layers=5, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=512,
        ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_chunk=32,
        attn_every=2,
    )
