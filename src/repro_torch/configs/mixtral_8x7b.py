"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""

from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=32000,
        n_experts=8, top_k=2, expert_d_ff=14336,
        sliding_window=4096,
        accum_steps=2,        # fits the 16 GB/chip HBM budget at train_4k
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="mixtral-8x7b-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512,
        n_experts=4, top_k=2, expert_d_ff=256,
        sliding_window=32,
    )
