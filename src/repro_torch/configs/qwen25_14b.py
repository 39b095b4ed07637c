"""qwen2.5-14b [dense]: GQA + QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""

from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2.5-14b", family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab_size=152064,
        qkv_bias=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2.5-14b-smoke", family="dense",
        n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512,
        qkv_bias=True,
    )
