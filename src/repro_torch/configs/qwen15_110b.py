"""qwen1.5-110b [dense]: GQA + QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""

from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=49152, vocab_size=152064,
        qkv_bias=True,
        fsdp_params=True,     # 444 GB fp32 params exceed 16 GB/chip under TP-only
        accum_steps=4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen1.5-110b-smoke", family="dense",
        n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=384, vocab_size=512,
        qkv_bias=True,
    )
