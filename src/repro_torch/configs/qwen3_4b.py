"""qwen3-4b [dense]: qk_norm + GQA.  [hf:Qwen/Qwen3-8B; hf]"""

from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=9728, vocab_size=151936,
        qk_norm=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-4b-smoke", family="dense",
        n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512,
        qk_norm=True,
    )
