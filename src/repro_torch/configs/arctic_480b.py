"""arctic-480b [moe]: 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]"""

from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=4864, vocab_size=32000,
        n_experts=128, top_k=2, expert_d_ff=4864, dense_residual=True,
        param_dtype="bfloat16",        # 480B fp32 masters would not fit 16 GB/chip
        accum_steps=2,
        fsdp_params=True,              # 960 GB of bf16 experts never fit TP-only
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="arctic-480b-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab_size=512,
        n_experts=4, top_k=2, expert_d_ff=128, dense_residual=True,
    )
